"""Global control plane: cross-gateway shard rebalancing + death failover.

The federation plane (doc/federation.md) lets G gateways jointly host
one world, and the spatial balancer (doc/balancer.md) keeps load flat
*inside* a gateway — but a hot gateway could only shed, never hand
territory to an idle peer, and a dead gateway stranded its entire
shard. This module closes both gaps at the fleet level, in the
continuous-repartitioning tradition of streaming spatial systems
(PAPERS.md: CheetahGIS) with the transactional, deterministically
recoverable cross-node migration discipline of geo-replicated stores
(Spider):

**Rebalancing.** Once per control epoch every gateway exports a load
vector over its trunks — smoothed overload pressure + ladder level,
resident entities (total and per hosted shard block), a crossing-rate
EWMA, and the observed trunk RTT. The deterministic leader (lowest
live gateway id — every gateway computes the same answer from its own
trunk view) folds the vectors into a fleet max/mean imbalance score
and, with the balancer's guard discipline (two-sided hysteresis, a
per-window migration budget, per-cell cooldown, an improvement guard,
and a HARD veto while the overload ladder sits at L2+ on either end),
plans one per-cell shard migration at a time: it bumps the shard
directory's override version, broadcasts the new cell->gateway
mapping, and tells the source gateway to drain the cell's residents
through the ordinary trunked transactional handover (journal prepare
-> trunk prepare -> remote apply -> ack commit, deterministic abort on
refusal/timeout/trunk loss) with pre-staged client redirects for
anchored clients. The source reports the terminal result back; an
aborted or refused plan reverts the directory override.

**Death failover.** Each epoch every gateway also replicates its shard
to every trunk peer: per-cell packed authoritative state (+ an entity
census), staged recovery handles AND live client sessions, its
in-flight outbound handover journal records, and its applied-batch
registry. When a peer's trunks stay silent past the miss threshold the
leader declares it dead, re-maps its cells to the least-loaded
survivor via directory overrides, and broadcasts the declaration. The
adopter then re-hosts the shard the way PR 3 re-hosts cells — with an
adoption census handshake first (survivors claim entities that
legitimately migrated to them after the replica's snapshot, so exactly
one live copy survives):

- replica cells become local spatial channels bootstrapped from the
  packed state (minus claimed / locally-live / in-flight entities);
- the replicated journal replays **source-wins**: in-flight outbound
  batches' entities are restored to their src cells and abort notices
  go to each batch's destination (purging any applied copy);
- the replicated applied-batch registry is installed so initiators'
  retransmitted abort notices (re-targeted from the dead gateway to
  the adopter) purge exactly the entities those batches left behind;
- replicated recovery handles are re-staged so redirected (and
  disconnected) clients resume on the adopter without re-auth.

Survivors that had committed handovers INTO the dead gateway resurrect
any batch not yet covered by the dead's last replica (the entities
would otherwise be lost with it); covered batches are left to the
adopter's bootstrap.

Every terminal migration result and every adoption is double-counted
(python ledger here AND ``global_migrations_total{result}`` /
``gateway_adoptions_total``) so the 3-gateway soak
(``scripts/global_soak.py``) proves the accounting exact. Operator
knobs + the interaction matrix with overload/failover/balancer:
doc/global_control.md.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from ..core.settings import global_settings
from ..core.tracing import new_trace_id, recorder as _trace
from ..core.types import ChannelDataAccess, ChannelType, ConnectionType, \
    MessageType
from ..protocol import control_pb2
from ..utils.anyutil import pack_any, unpack_any
from ..utils.logger import get_logger
from .directory import directory

logger = get_logger("federation.control")

# Committed-batch retention per peer: batches committed INTO a peer are
# kept (records + data) until the peer's next shard replica covers
# their entities — the resurrection material if the peer dies first.
MAX_RETAINED_BATCHES = 1024

# Soak-forensics event-list cap (control plane and federation plane
# both trim at this bound; the soaks harvest the tail).
MAX_EVENTS = 4096


def append_event(events: list, e: dict) -> None:
    """Shared bounded event ledger for the federation and control
    planes: monotonic stamp (orderable across co-hosted gateway
    processes — events alone can't sequence a cross-gateway race),
    amortized trim so a long-lived gateway never grows the list
    forever (keeps list slicing for the soak harvesters)."""
    e.setdefault("t", round(time.monotonic(), 3))
    events.append(e)
    if len(events) > MAX_EVENTS:
        del events[: MAX_EVENTS // 2]


@dataclass
class ShardPlan:
    """Leader-side in-flight shard migration."""

    plan_id: int
    cell_id: int
    src: str
    dst: str
    version: int
    deadline: float
    trace_id: str
    planned_epoch: int


@dataclass
class ShardDrain:
    """Source-side in-flight shard migration (drive the drain, report
    the terminal result to the leader)."""

    plan_id: int
    cell_id: int
    dst: str
    leader: str
    trace_id: str
    started_epoch: int
    entities_at_start: int
    moved: int = 0
    refused: bool = False
    t0: float = 0.0


class GlobalControlPlane:
    """One instance (``control``); disarmed until ``plane.start()`` arms
    it (federation on + ``global_control_enabled``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.active = False
        self.plane = None  # the FederationPlane, set by start()
        self._tasks: list[asyncio.Task] = []
        self.epoch = 0
        # gateway id -> last load vector (dict form; includes self).
        self.vectors: dict[str, dict] = {}
        # peer -> last TrunkShardEpochMessage received.
        self.replicas: dict[str, object] = {}
        self._seen_up: set[str] = set()
        self._down_since: dict[str, float] = {}
        self.dead: set[str] = set()
        # Leader planning state.
        self._plan_seq = 0
        self._plans: dict[int, ShardPlan] = {}
        self._hold = 0
        self._armed = False
        self._cooldown: dict[int, int] = {}  # cell -> epoch until
        self._window_start = 0
        self._window_committed = 0
        self.imbalance = 0.0
        # Source-side drain state (one at a time).
        self._drain: Optional[ShardDrain] = None
        # peer -> OrderedDict[batch_id, PendingBatch]: committed into the
        # peer, not yet covered by its replica (resurrection material).
        self._retained: dict[str, OrderedDict] = {}
        # Adoption census handshake in flight (at most one; later
        # deaths queue behind it).
        self._adoption: Optional[dict] = None
        self._adoption_queue: list[dict] = []
        # dead gateway -> this survivor's OFFERED resurrection
        # candidates: batches committed INTO the dead after its last
        # replica snapshot. The data stays here; the ids ride the
        # claims reply and ONLY an adopter grant (TrunkAdoptDone
        # restoreEntityIds) — or the fallback deadline when the census
        # never resolves — restores them, so exactly one gateway
        # restores each entity.
        self._offered: dict[str, dict] = {}
        # cell id -> epoch first seen remote-mapped while still hosted
        # here (purged only after a grace period + re-check).
        self._purge_candidates: dict[int, int] = {}
        # Anti-entropy hold-down after a declared-dead peer returns:
        # gives the survivors' directory sync time to land before this
        # gateway (possibly a stale just-returned leader) re-asserts.
        self._heal_hold_until = 0
        # peer -> consecutive epochs its reported directory version
        # trailed ours (leader-side; >= 3 triggers a replace re-sync).
        self._behind_streak: dict[str, int] = {}
        self._geo_behind_streak: dict[str, int] = {}
        # Peers that announced a graceful-shutdown goodbye: the death
        # declaration skips the miss window for them (the silence is
        # intentional, not ambiguous; doc/device_recovery.md).
        self._goodbyes: set[str] = set()
        self._crossings_acc = 0
        self._crossing_rate = 0.0
        # Resurrection handshake state (doc/persistence.md): armed by
        # the WAL boot replay on a crash-restarted gateway; None on a
        # fresh boot. Holds the peers announced to, their acks, and the
        # terminal resolution (yielded / reclaimed / unresolved).
        self._resurrect: Optional[dict] = None
        # Python-side ledgers; must match global_migrations_total{result}
        # and gateway_adoptions_total exactly — and resurrections must
        # match resurrection_total{outcome}.
        self.resurrections: dict[str, int] = {}
        self.ledger: dict[str, int] = {}
        self.adoptions = 0
        self.deaths = 0
        self.counters: dict[str, int] = {}  # soak-visible side accounting
        self.events: list[dict] = []

    # ---- accounting ------------------------------------------------------

    def _count(self, result: str, n: int = 1) -> None:
        self.ledger[result] = self.ledger.get(result, 0) + n
        from ..core import metrics

        metrics.global_migrations.labels(result=result).inc(n)

    def _note(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def _count_resurrection(self, outcome: str, n: int = 1) -> None:
        self.resurrections[outcome] = \
            self.resurrections.get(outcome, 0) + n
        from ..core import metrics

        metrics.resurrection.labels(outcome=outcome).inc(n)

    def _event(self, e: dict) -> None:
        append_event(self.events, e)

    # ---- lifecycle -------------------------------------------------------

    def start(self, plane) -> None:
        self.plane = plane
        self.active = True
        self._tasks = [asyncio.ensure_future(self._epoch_loop())]
        logger.info(
            "global control plane up on gateway %s (epoch %dms, leader "
            "rule: lowest live id)", directory.local_id,
            global_settings.global_epoch_ms,
        )

    def stop(self) -> None:
        self.active = False
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        self.plane = None

    # ---- cheap hot-path intake -------------------------------------------

    def note_crossing(self, n: int) -> None:
        """Crossing-rate signal for the load vector (fed from grid
        orchestration and cross-gateway initiation)."""
        if self.active:
            self._crossings_acc += n

    def note_batch_committed(self, batch) -> None:
        """A cross-gateway batch committed INTO batch.peer: retain it
        until the peer's replica covers the entities (the peer dying
        before then would otherwise lose them)."""
        if not self.active:
            return
        d = self._drain
        if d is not None and batch.src_channel_id == d.cell_id:
            # The drain's shipped-entity count: what ACTUALLY went over
            # the trunk (residents can also leave by ordinary crossings
            # mid-drain — entities_at_start would over-count them).
            d.moved += len(batch.records)
        retained = self._retained.setdefault(batch.peer, OrderedDict())
        retained[batch.batch_id] = batch
        while len(retained) > MAX_RETAINED_BATCHES:
            retained.popitem(last=False)

    def note_batch_aborted(self, batch, busy: bool) -> None:
        """Drain bookkeeping: a refusal of the drained cell's batch means
        the destination is at L3 — the plan must report `refused`."""
        d = self._drain
        if d is not None and batch.dst_channel_id == d.cell_id and busy:
            d.refused = True

    # ---- liveness / leadership -------------------------------------------

    def live_peers(self) -> list[str]:
        if self.plane is None:
            return []
        return [
            p for p in directory.peers()
            if p not in self.dead and self.plane.link_to(p) is not None
        ]

    def leader(self) -> str:
        return min([directory.local_id] + self.live_peers())

    def is_leader(self) -> bool:
        return self.leader() == directory.local_id

    def on_trunk_up(self, peer: str) -> None:
        self._seen_up.add(peer)
        self._down_since.pop(peer, None)
        # A returning peer supersedes any earlier goodbye (it restarted).
        self._goodbyes.discard(peer)
        if self._resurrect is not None and not self._resurrect["resolved"]:
            # Crash-restarted gateway: introduce ourselves on every
            # trunk as it comes up (doc/persistence.md).
            self._announce_resurrection(peer)
        if peer in self.dead:
            # A declared-dead gateway reconnected (it was partitioned,
            # not crashed). Its shard has been adopted; sync it the
            # current directory so it purges its stale copies and can
            # serve as a standby.
            logger.warning("declared-dead gateway %s reconnected", peer)
            self.dead.discard(peer)
            # Its pre-death replica is stale — the next epoch brings a
            # fresh one; adopting from the old one after a quick second
            # death would resurrect entities removed since.
            self._drop_replica(peer)
            # BOTH sides of a heal observe the other's return (each
            # declared the other dead): hold re-assertion down so the
            # surviving side's sync lands before a stale just-returned
            # lowest-id gateway can clobber the fleet map with its own.
            self._heal_hold_until = max(
                self._heal_hold_until, self.epoch + 2
            )
            # The sync leader EXCLUDES the returnee: with it counted, a
            # returning lowest-id gateway would make every survivor
            # compute "not leader" and nobody would sync it at all.
            survivors = [
                g for g in [directory.local_id] + self.live_peers()
                if g != peer
            ]
            if survivors and min(survivors) == directory.local_id:
                self._sync_directory(peer)

    def on_trunk_down(self, peer: str) -> None:
        if self.active and peer in self._seen_up:
            self._down_since.setdefault(peer, time.monotonic())

    def on_peer_goodbye(self, peer: str) -> None:
        """The peer sent a graceful-shutdown farewell: its trunk silence
        is intentional, so the leader declares the death at the NEXT
        epoch tick instead of waiting out global_death_miss_epochs —
        the shard re-maps in one epoch and clients redirect instead of
        timing out against a corpse."""
        if not self.active or peer in self.dead:
            return
        self._goodbyes.add(peer)
        self._event({"kind": "peer_goodbye", "peer": peer})
        logger.warning(
            "gateway %s said goodbye (graceful shutdown); death "
            "declaration fast-tracked", peer,
        )

    def _sync_directory(self, peer: str) -> None:
        """Full-map replace sync to one returned gateway. If the
        returnee's version is HIGHER than ours (it ran its own
        declarations while partitioned), this send is rejected there as
        stale — its next load report carries that version and
        _reassert_directory fast-forwards past it."""
        link = self.plane.link_to(peer)
        if link is None:
            return
        msg = control_pb2.TrunkDirectoryUpdateMessage(
            version=directory.override_version, replaceOverrides=True,
        )
        for cid, gw in directory.overrides().items():
            msg.overrides.add(channelId=cid, gatewayId=gw)
        link.send(MessageType.TRUNK_DIRECTORY_UPDATE, msg)

    def _reassert_directory(self) -> None:
        """Leader anti-entropy over the load-report directory versions.
        Two divergence directions after a healed partition:

        - a live peer reports a version AHEAD of ours (it ran its own
          declarations while partitioned): every plain broadcast is
          rejected there as stale forever, and the overrides it minted
          keep two live authoritative copies of those cells in the
          fleet. Fast-forward past its version and re-assert the full
          map as a REPLACE sync fleet-wide — which also puts the
          returnee's stale hosted copies through the purge/evacuation
          lifecycle.
        - a live peer trails BEHIND ours for several consecutive epochs
          (its partition-side version lost to ours on heal, or it
          missed a broadcast): per-plan deltas never catch it up, so
          re-sync just that peer. The streak threshold rides out the
          one-epoch reporting lag every normal plan bump causes.

        The whole check holds down for a couple of epochs after a
        declared-dead peer returns, so the surviving side's trunk-up
        sync lands before a stale just-returned lowest-id gateway can
        re-assert its own map over the fleet's. (Equal versions with
        divergent maps — both sides bumped the same number of times —
        are not detectable from the version alone; the next genuine
        mutation resolves them.)"""
        if self.epoch < self._heal_hold_until:
            return
        my_v = directory.override_version
        ahead = max(
            (v.get("directory_version") or 0
             for p, v in self.vectors.items()
             if p != directory.local_id and p not in self.dead),
            default=0,
        )
        if ahead > my_v:
            version = ahead + 1
            full = directory.overrides()
            logger.warning(
                "directory anti-entropy: a live peer is at v%d > local "
                "v%d (partitioned concurrent leader) — re-asserting %d "
                "overrides at v%d", ahead, my_v, len(full), version,
            )
            changed = directory.replace_update(full, version)
            if changed:
                self.on_directory_update(changed)
            msg = control_pb2.TrunkDirectoryUpdateMessage(
                version=version, replaceOverrides=True,
            )
            for cid, gw in sorted(full.items()):
                msg.overrides.add(channelId=cid, gatewayId=gw)
            for peer in self.live_peers():
                link = self.plane.link_to(peer)
                if link is not None:
                    link.send(MessageType.TRUNK_DIRECTORY_UPDATE, msg)
            return
        for p in self.live_peers():
            v = self.vectors.get(p, {}).get("directory_version")
            if v is None:
                continue
            if v < my_v:
                streak = self._behind_streak.get(p, 0) + 1
                if streak >= 3:
                    logger.warning(
                        "directory anti-entropy: %s stuck at v%d < "
                        "local v%d for %d epochs — re-syncing",
                        p, v, my_v, streak,
                    )
                    streak = 0
                    self._sync_directory(p)
                self._behind_streak[p] = streak
            else:
                self._behind_streak.pop(p, None)

    def _sync_geometry(self, peer: str) -> None:
        """Full geometry sync to one trunk peer (adaptive partitioning,
        doc/partitioning.md): the complete split set under the current
        epoch, idempotently applicable — the receiver keeps its own
        local-cell splits and adopts ours for the rest."""
        from ..spatial.controller import get_spatial_controller

        ctl = get_spatial_controller()
        tree = getattr(ctl, "tree", None) if ctl is not None else None
        if tree is None:
            return
        link = self.plane.link_to(peer)
        if link is None:
            return
        from ..protocol import spatial_pb2

        link.send(
            MessageType.CELL_GEOMETRY_UPDATE,
            spatial_pb2.CellGeometryUpdateMessage(
                geometryEpoch=tree.epoch,
                splitCells=sorted(tree.splits),
                op="sync",
            ),
        )

    def _reassert_geometry(self) -> None:
        """Leader anti-entropy over the load-report geometry epochs,
        mirroring _reassert_directory: a live peer AHEAD of us ran its
        own splits while partitioned (concurrent leader) — fast-forward
        past its epoch, merging its view on next sync; a peer trailing
        BEHIND for several consecutive epochs missed updates — re-sync
        just that peer."""
        if self.epoch < self._heal_hold_until:
            return
        from ..spatial.controller import get_spatial_controller

        ctl = get_spatial_controller()
        tree = getattr(ctl, "tree", None) if ctl is not None else None
        if tree is None:
            return
        my_e = tree.epoch
        ahead = max(
            (v.get("geometry_epoch") or 0
             for p, v in self.vectors.items()
             if p != directory.local_id and p not in self.dead),
            default=0,
        )
        if ahead > my_e:
            # Keep our split set, fast-forward the epoch so our next
            # assertion is not rejected fleet-wide as stale.
            logger.warning(
                "geometry anti-entropy: a live peer is at epoch %d > "
                "local %d (partitioned concurrent split) — "
                "fast-forwarding and re-asserting", ahead, my_e,
            )
            ctl.apply_geometry(ahead + 1, tree.splits)
            for peer in self.live_peers():
                self._sync_geometry(peer)
            return
        for p in self.live_peers():
            e = self.vectors.get(p, {}).get("geometry_epoch")
            if e is None:
                continue
            if e < my_e:
                streak = self._geo_behind_streak.get(p, 0) + 1
                if streak >= 3:
                    logger.warning(
                        "geometry anti-entropy: %s stuck at epoch %d < "
                        "local %d for %d epochs — re-syncing",
                        p, e, my_e, streak,
                    )
                    streak = 0
                    self._sync_geometry(p)
                self._geo_behind_streak[p] = streak
            else:
                self._geo_behind_streak.pop(p, None)

    def on_geometry_update(self, peer: str, msg) -> None:
        """A trunk peer asserted its cell geometry. Adopt the remote
        split set for cells mapped to OTHER gateways; splits under
        locally-mapped base cells stay exactly as the local partition
        plane committed them (it is the only authority for them, and a
        remote view may be an epoch stale)."""
        from ..spatial.controller import get_spatial_controller

        ctl = get_spatial_controller()
        tree = getattr(ctl, "tree", None) if ctl is not None else None
        if tree is None:
            return
        epoch = msg.geometryEpoch
        if epoch <= tree.epoch:
            return  # stale assertion; our next load report corrects them

        def _local(s: int) -> bool:
            return directory.is_local_cell(tree.start + tree.base_cell_of(s))

        keep = {s for s in tree.splits if _local(s)}
        take = set()
        for s in msg.splitCells:
            try:
                if not _local(s):
                    take.add(s)
            except ValueError:
                continue  # undecodable under our depth bound: drop
        merged = frozenset(keep | take)
        err = tree.validate_splits(merged)
        if err is not None:
            logger.error(
                "geometry update from %s (epoch %d) merged invalid "
                "(%s); keeping local epoch %d",
                peer, epoch, err, tree.epoch,
            )
            return
        ctl.apply_geometry(epoch, merged)
        from ..core.wal import wal as _wal

        if _wal.enabled:
            _wal.log_geometry(epoch, merged)
        logger.info(
            "geometry update from %s applied: epoch %d, %d split cells "
            "(%d local kept)", peer, epoch, len(merged), len(keep),
        )

    # ---- the control epoch -----------------------------------------------

    async def _epoch_loop(self) -> None:
        while self.active:
            try:
                await asyncio.sleep(
                    global_settings.global_epoch_ms / 1000.0
                )
            except asyncio.CancelledError:
                return
            if not self.active:
                return
            self.plane._in_global_tick(self._epoch_tick)

    def _epoch_tick(self) -> None:
        """One control epoch, inside the GLOBAL channel tick (the same
        single-writer context every channel mutation requires)."""
        if not self.active:
            return
        self.epoch += 1
        vector = self._build_vector()
        self.vectors[directory.local_id] = vector
        self._export(vector)
        self._replicate()
        self._check_adoption_deadline()
        self._advance_offered()
        self._advance_drain()
        self._advance_purges()
        self._sweep_stale_rows()
        self._check_deaths()
        if self.is_leader():
            self._reassert_directory()
            self._reassert_geometry()
            self._check_plan_deadlines()
            self._plan()

    # ---- load vector -----------------------------------------------------

    def _local_cell_channels(self):
        """Live locally-mapped spatial cell channels. Bounded by the
        grid size when a grid controller is up — the epoch runs inside
        the GLOBAL tick every global_epoch_ms, and an all_channels()
        scan there is O(entity channels), not O(cells)."""
        from ..core.channel import all_channels, get_channel
        from ..spatial.controller import get_spatial_controller

        st = global_settings
        lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start
        ctl = get_spatial_controller()
        tree = getattr(ctl, "tree", None) if ctl is not None else None
        if tree is not None:
            # Geometry-aware: split children are live cells too, and a
            # split parent is not (adaptive partitioning).
            for cid in tree.leaves():
                ch = get_channel(cid)
                if ch is not None and not ch.is_removing() \
                        and directory.is_local_cell(cid):
                    yield cid, ch
            return
        n_cells = getattr(ctl, "grid_cols", 0) * getattr(ctl, "grid_rows", 0)
        if n_cells:
            for cid in range(lo, lo + n_cells):
                ch = get_channel(cid)
                if ch is not None and not ch.is_removing() \
                        and directory.is_local_cell(cid):
                    yield cid, ch
            return
        for cid, ch in all_channels().items():
            if lo <= cid < hi and not ch.is_removing() \
                    and directory.is_local_cell(cid):
                yield cid, ch

    def _build_vector(self) -> dict:
        from ..core.failover import entity_count_of
        from ..core.overload import governor

        entities = cells = 0
        blocks: dict[int, int] = {}
        for cid, ch in self._local_cell_channels():
            n = entity_count_of(ch)
            entities += n
            cells += 1
            idx = directory.server_index_of(cid)
            if idx is not None:
                blocks[idx] = blocks.get(idx, 0) + n
        alpha = global_settings.overload_alpha
        self._crossing_rate = (
            alpha * self._crossings_acc
            + (1.0 - alpha) * self._crossing_rate
        )
        self._crossings_acc = 0
        rtts = [
            link.rtt_ms
            for p in self.live_peers()
            if (link := self.plane.link_to(p)) is not None and link.rtt_ms
        ]
        return {
            "gateway": directory.local_id,
            "epoch": self.epoch,
            "pressure": round(governor.pressure, 4),
            "level": int(governor.level),
            "entities": entities,
            "cells": cells,
            "crossing_rate": round(self._crossing_rate, 3),
            "trunk_rtt_ms": round(sum(rtts) / len(rtts), 3) if rtts else 0.0,
            "blocks": blocks,
            "directory_version": directory.override_version,
            "geometry_epoch": self._geometry_epoch(),
        }

    @staticmethod
    def _geometry_epoch() -> int:
        from ..spatial.controller import get_spatial_controller

        ctl = get_spatial_controller()
        tree = getattr(ctl, "tree", None) if ctl is not None else None
        return tree.epoch if tree is not None else 0

    def _export(self, vector: dict) -> None:
        msg = control_pb2.TrunkLoadReportMessage(
            gatewayId=vector["gateway"],
            epoch=vector["epoch"],
            pressure=vector["pressure"],
            overloadLevel=vector["level"],
            entities=vector["entities"],
            cells=vector["cells"],
            crossingRate=vector["crossing_rate"],
            trunkRttMs=vector["trunk_rtt_ms"],
            blockIndices=sorted(vector["blocks"]),
            blockEntities=[
                vector["blocks"][i] for i in sorted(vector["blocks"])
            ],
            directoryVersion=vector["directory_version"],
            geometryEpoch=vector["geometry_epoch"],
        )
        from ..core.slo import slo as _slo

        if _slo.enabled:
            # Fleet metric federation (federation/obs.py): the digest
            # rides the load report — no extra trunk traffic, and any
            # gateway's /fleet shows every peer one epoch later.
            from .obs import fleet

            fleet.attach_digest(msg)
        for peer in self.live_peers():
            link = self.plane.link_to(peer)
            if link is not None:
                link.send(MessageType.TRUNK_LOAD_REPORT, msg)

    # ---- shard replication -----------------------------------------------

    def _replicate(self) -> None:
        from ..core.channel import all_channels
        from ..core.connection_recovery import _recover_handles
        from ..core.failover import journal
        from ..core.snapshot import pack_channel_state

        peers = self.live_peers()
        if not peers:
            return
        st = global_settings
        lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start
        msg = control_pb2.TrunkShardEpochMessage(epochSeq=self.epoch)
        handle_channels: dict[str, list[int]] = {}
        anchor_of: dict[str, int] = {}
        for cid, ch in all_channels().items():
            if ch.is_removing():
                continue
            is_cell = lo <= cid < hi
            if is_cell and directory.is_local_cell(cid):
                rc = msg.cells.add(channelId=cid)
                packed = pack_channel_state(ch)
                if packed is not None:
                    rc.data.CopyFrom(packed)
                ents = getattr(ch.get_data_message(), "entities", None)
                if ents is not None:
                    rc.entityIds.extend(sorted(ents))
            # Recovery-handle stashes (staged redirects in flight) and
            # live client sessions both replicate: either kind resumes
            # on the adopter through an ordinary staged handle.
            for pit, rsub in ch.recoverable_subs.items():
                if rsub.conn_handle.staged:
                    handle_channels.setdefault(pit, []).append(cid)
            for conn in ch.subscribed_connections:
                if (
                    conn is not None and not conn.is_closing()
                    and conn.connection_type == ConnectionType.CLIENT
                    and conn.pit
                ):
                    handle_channels.setdefault(conn.pit, []).append(cid)
        if self.plane is not None:
            for conn, eid in self.plane.client_anchors.values():
                if conn.pit:
                    anchor_of[conn.pit] = eid
        # Staged handles whose channels all vanished already still ride
        # (the pit alone lets the client resume unsubscribed).
        for pit, handle in _recover_handles.items():
            if handle.staged and pit not in handle_channels:
                handle_channels[pit] = []
        for pit, cids in sorted(handle_channels.items()):
            msg.handles.add(
                pit=pit, channelIds=sorted(set(cids)),
                entityId=anchor_of.get(pit, 0),
            )
        # ALL in-flight journal records ride — local hops too: an
        # entity mid-local-crossing is in neither cell's data rows, so
        # without its journal record the replica (and any adoption from
        # it) is blind to the entity. Remote records group under their
        # PENDING BATCH's wire id: the destination's applied registry
        # (and so the adoption's abort notices) key on the batch id,
        # which is the FIRST record's txn id — per-record ids would
        # stop matching the moment the first record is forgotten
        # (entity destroyed mid-flight).
        live_recs = {(r.entity_id, r.txn_id)
                     for r in journal.in_flight_records()}
        in_batch: set[tuple] = set()
        if self.plane is not None:
            for batch in self.plane._pending.values():
                recs = [r for r in batch.records
                        if (r.entity_id, r.txn_id) in live_recs]
                if not recs:
                    continue
                txn = msg.txns.add(
                    batchId=batch.batch_id,
                    srcChannelId=batch.src_channel_id,
                    dstChannelId=batch.dst_channel_id, peer=batch.peer,
                )
                for rec in recs:
                    in_batch.add((rec.entity_id, rec.txn_id))
                    e = txn.entities.add(entityId=rec.entity_id,
                                         txnId=rec.txn_id)
                    if rec.data is not None:
                        e.data.CopyFrom(pack_any(rec.data))
        for rec in journal.in_flight_records():
            if (rec.entity_id, rec.txn_id) in in_batch:
                continue
            peer = directory.gateway_of_cell(rec.dst_channel_id) or ""
            txn = msg.txns.add(
                batchId=rec.txn_id, srcChannelId=rec.src_channel_id,
                dstChannelId=rec.dst_channel_id, peer=peer,
            )
            e = txn.entities.add(entityId=rec.entity_id, txnId=rec.txn_id)
            if rec.data is not None:
                e.data.CopyFrom(pack_any(rec.data))
        for (src_peer, batch_id), (_dst, eids) in \
                self.plane._applied.items():
            msg.applied.add(batchId=batch_id, peer=src_peer,
                            entityIds=eids)
        # Sensor-scope standing queries ride the replica next to the
        # staged handles: an adopter re-registers them on its own query
        # plane (spatial/queryplane.py) so a server sensor survives its
        # gateway's death. Connection-scoped rows stay home — their
        # sockets die with the gateway and clients re-issue on resume.
        from ..spatial.controller import get_spatial_controller

        _ctl = get_spatial_controller()
        _qp = getattr(_ctl, "queryplane", None) if _ctl is not None else None
        if _qp is not None:
            for key, scope, name, kind, params, spot_dists in \
                    _qp.snapshot_rows():
                if scope != "sensor":
                    continue
                msg.queries.add(key=key, scope=scope, name=name, kind=kind,
                                params=params, spotDists=spot_dists)
        for peer in peers:
            link = self.plane.link_to(peer)
            if link is not None:
                link.send(MessageType.TRUNK_SHARD_EPOCH, msg)

    def replicate_txns(self, records, dst_gateway: str,
                       batch_id: int) -> None:
        """Eager delta replication of a just-prepared outbound batch to
        every trunk peer. The full shard replica rides once per control
        epoch — a source that dies right after preparing a batch whose
        TrunkHandoverPrepare never reached the destination would
        otherwise hold the ONLY copy of those entities (the loss window
        the epoch cadence leaves open; the adoption census has nothing
        to restore from). Receivers merge the delta into their stored
        replica; the source's next full epoch supersedes it."""
        if not self.active:
            return
        msg = control_pb2.TrunkShardEpochMessage(delta=True)
        # ONE txn under the batch's wire id (the first record's txn
        # id): the destination's applied registry — and so the
        # adoption's abort notices — match on the batch id.
        txn = msg.txns.add(
            batchId=batch_id, srcChannelId=records[0].src_channel_id,
            dstChannelId=records[0].dst_channel_id, peer=dst_gateway,
        )
        for rec in records:
            e = txn.entities.add(entityId=rec.entity_id, txnId=rec.txn_id)
            if rec.data is not None:
                e.data.CopyFrom(pack_any(rec.data))
        for p in self.live_peers():
            link = self.plane.link_to(p)
            if link is not None:
                link.send(MessageType.TRUNK_SHARD_EPOCH, msg)

    def _on_shard_epoch(self, peer: str, msg) -> None:
        if msg.delta:
            # Just-prepared-batch delta: merge into the stored replica
            # (a bare one pre-first-epoch) so an adoption between now
            # and the source's next full epoch can source-wins-replay
            # the batch. The next full epoch replaces wholesale —
            # committed/aborted batches drop out with it.
            rep = self.replicas.get(peer)
            if rep is None:
                rep = control_pb2.TrunkShardEpochMessage()
                self.replicas[peer] = rep
            have = {t.batchId for t in rep.txns}
            for txn in msg.txns:
                if txn.batchId not in have:
                    rep.txns.add().CopyFrom(txn)
            return
        self.replicas[peer] = msg
        covered = self._replica_entity_ids(peer)
        retained = self._retained.get(peer)
        if retained:
            # Commit-retention pruning: batches whose entities the peer
            # now replicates are survivable without us.
            for batch_id in [
                b for b, batch in retained.items()
                if all(r.entity_id in covered for r in batch.records)
            ]:
                del retained[batch_id]
        self._update_replica_gauge()

    def _drop_replica(self, peer: str) -> None:
        """The peer's replica is spent (its shard was adopted) or stale
        (it reconnected and will replicate fresh): holding it would
        inflate the gauge forever — and a reconnect-then-quick-second-
        death would re-adopt from the PRE-reconnect snapshot,
        resurrecting entities legitimately removed since."""
        if self.replicas.pop(peer, None) is not None:
            self._update_replica_gauge()

    def _update_replica_gauge(self) -> None:
        from ..core import metrics

        metrics.shard_replica_entities.set(sum(
            sum(len(rc.entityIds) for rc in rep.cells)
            for rep in self.replicas.values()
        ))

    def _replica_entity_ids(self, peer: str) -> set[int]:
        return self._ids_of_replica(self.replicas.get(peer))

    @staticmethod
    def _ids_of_replica(rep) -> set[int]:
        if rep is None:
            return set()
        ids: set[int] = set()
        for rc in rep.cells:
            ids.update(rc.entityIds)
        for txn in rep.txns:
            ids.update(e.entityId for e in txn.entities)
        return ids

    # ---- leader: planning ------------------------------------------------

    def _scores(self) -> Optional[dict[str, float]]:
        st = global_settings
        gateways = [directory.local_id] + self.live_peers()
        if len(gateways) < 2:
            return None
        scores: dict[str, float] = {}
        for gw in gateways:
            v = self.vectors.get(gw)
            if v is None:
                return None  # can't plan without everyone's vector
            scores[gw] = (
                v["entities"]
                + v["crossing_rate"] * st.balancer_crossing_weight
                + v["pressure"] * st.balancer_pressure_weight
            )
        return scores

    def _plan(self) -> None:
        from ..core import metrics
        from ..core.overload import OverloadLevel, governor

        st = global_settings
        scores = self._scores()
        if scores is None:
            self._hold = 0
            return
        ents = {gw: self.vectors[gw]["entities"] for gw in scores}
        if max(ents.values()) - min(ents.values()) \
                < st.global_min_entity_delta:
            self._hold = 0
            self._armed = False
            return
        mean = sum(scores.values()) / len(scores)
        self.imbalance = (max(scores.values()) / mean) if mean > 0 else 0.0
        metrics.global_imbalance.set(self.imbalance)
        if self._armed:
            if self.imbalance < st.global_imbalance_exit:
                self._armed = False
                self._hold = 0
                return
        elif self.imbalance >= st.global_imbalance_enter:
            self._hold += 1
            if self._hold >= st.global_hold_epochs:
                self._armed = True
        else:
            self._hold = 0
            return
        if not self._armed:
            return
        if self._plans or self._drain is not None \
                or self._adoption is not None:
            return  # one fleet-level mutation at a time
        if self.epoch - self._window_start >= st.global_budget_window_epochs:
            self._window_start = self.epoch
            self._window_committed = 0
        if self._window_committed >= st.global_budget_per_window:
            return
        hottest = max(scores, key=lambda g: (scores[g], g))
        coldest = min(scores, key=lambda g: (scores[g], g))
        if hottest == coldest:
            return
        # The hard veto: shedding outranks rebalancing, fleet-wide.
        if governor.level >= OverloadLevel.L2 or max(
            self.vectors[hottest]["level"], self.vectors[coldest]["level"]
        ) >= 2:
            self._count("vetoed")
            self._hold = 0
            logger.warning(
                "shard migration vetoed: overload L2+ (local L%d, src L%d, "
                "dst L%d)", governor.level, self.vectors[hottest]["level"],
                self.vectors[coldest]["level"],
            )
            return
        cell_id, cell_ents = self._pick_cell(
            hottest, scores[hottest], scores[coldest]
        )
        if cell_id is None:
            return
        self._plan_seq += 1
        plan_id = self._plan_seq
        trace_id = new_trace_id(f"gmig-{directory.local_id}")
        plan_start = _trace.now()
        version = directory.override_version + 1
        # Through the lifecycle hook: when the leader is the
        # destination, nobody else creates the cell channel here.
        self._apply_directory_local({cell_id: coldest}, version)
        plan = ShardPlan(
            plan_id=plan_id, cell_id=cell_id, src=hottest, dst=coldest,
            version=version, trace_id=trace_id, planned_epoch=self.epoch,
            deadline=time.monotonic()
            + st.global_migrate_timeout_ms / 1000.0,
        )
        self._plans[plan_id] = plan
        self._count("planned")
        self._event({
            "kind": "plan", "plan": plan_id, "cell": cell_id,
            "src": hottest, "dst": coldest, "entities": cell_ents,
            "imbalance": round(self.imbalance, 4), "epoch": self.epoch,
            "trace": trace_id,
        })
        # Leader-plan span: the first third of the stitched
        # leader-plan -> src-drain -> dst-apply cross-gateway trace.
        _trace.span("ctl.plan", plan_start, trace=trace_id)
        logger.info(
            "shard migration %d planned: cell %d (%d entities), gateway "
            "%s -> %s (imbalance %.2f, directory v%d)",
            plan_id, cell_id, cell_ents, hottest, coldest,
            self.imbalance, version,
        )
        # The migrate command goes out BEFORE the directory broadcast:
        # trunk links are ordered, so the source sees its drain order
        # first and never mistakes the new mapping for a stale-copy
        # purge (the deferred-purge grace covers third parties).
        if hottest == directory.local_id:
            self._begin_drain(plan_id, cell_id, coldest,
                              directory.local_id, trace_id)
        else:
            link = self.plane.link_to(hottest)
            if link is not None:
                link.send(
                    MessageType.TRUNK_SHARD_MIGRATE,
                    control_pb2.TrunkShardMigrateMessage(
                        planId=plan_id, channelId=cell_id,
                        srcGateway=hottest, dstGateway=coldest,
                        directoryVersion=version, traceId=trace_id,
                    ),
                )
        self._broadcast_directory({cell_id: coldest}, version)

    def _pick_cell(self, hottest: str, hot_score: float,
                   cold_score: float):
        """The hottest gateway's most loaded migratable cell: from local
        data when the leader IS the hottest, else from its replica (an
        epoch stale — the improvement guard keeps a stale pick from
        relocating the hotspot)."""
        from ..core.failover import entity_count_of

        per_cell: dict[int, int] = {}
        if hottest == directory.local_id:
            for cid, ch in self._local_cell_channels():
                per_cell[cid] = entity_count_of(ch)
        else:
            rep = self.replicas.get(hottest)
            if rep is None:
                return None, 0
            for rc in rep.cells:
                per_cell[rc.channelId] = len(rc.entityIds)
        if len(per_cell) <= 1:
            return None, 0  # never strip a gateway's last cell
        candidates = sorted(
            ((n, cid) for cid, n in per_cell.items()
             if n > 0 and self._cooldown.get(cid, 0) <= self.epoch),
            reverse=True,
        )
        for n, cid in candidates:
            # Improvement guard: the move must flatten the fold — if the
            # post-move worst of (shrunken src, grown dst) is no better
            # than src today, migrating just relocates the hotspot.
            if max(hot_score - n, cold_score + n) < hot_score:
                return cid, n
        return None, 0

    def _broadcast_directory(self, overrides: dict[int, str],
                             version: int) -> None:
        msg = control_pb2.TrunkDirectoryUpdateMessage(version=version)
        for cid, gw in sorted(overrides.items()):
            msg.overrides.add(channelId=cid, gatewayId=gw)
        for peer in self.live_peers():
            link = self.plane.link_to(peer)
            if link is not None:
                link.send(MessageType.TRUNK_DIRECTORY_UPDATE, msg)

    def _apply_directory_local(self, overrides: dict[int, str],
                               version: int) -> None:
        """Locally-originated shard-map mutations (plan, abort revert,
        death re-map) get the same cell lifecycle as trunk-received
        updates (plane.py's TRUNK_DIRECTORY_UPDATE path): cells newly
        mapped here come up, cells mapped away while still hosted
        become purge candidates. Without this a leader that is itself
        the migration destination would keep unreachable zombie copies
        of a reverted cell, and a leader hosting a dead gateway's
        partially-applied entities would never evacuate them to the
        adopter."""
        if directory.apply_update(overrides, version):
            self.on_directory_update(overrides)

    def _check_plan_deadlines(self) -> None:
        now = time.monotonic()
        for plan in [p for p in self._plans.values() if now > p.deadline]:
            del self._plans[plan.plan_id]
            self._resolve_plan(plan, "aborted", "status timeout", 0)

    def _on_migrate_status(self, peer: str, msg) -> None:
        plan = self._plans.pop(msg.planId, None)
        if plan is None:
            return
        self._resolve_plan(plan, msg.result or "aborted", msg.reason,
                           msg.entities)

    def _resolve_plan(self, plan: ShardPlan, result: str, reason: str,
                      entities: int, revert: bool = True) -> None:
        st = global_settings
        if result not in ("committed", "aborted", "refused"):
            result = "aborted"
        self._count(result)
        self._cooldown[plan.cell_id] = self.epoch + st.global_cooldown_epochs
        if result == "committed":
            self._window_committed += 1
        else:
            # Revert: the cell stays with (goes back to) the source —
            # but never onto a gateway that has since died (the death
            # re-map owns the cell now; reverting would strand it on a
            # corpse), never over a mapping that already moved past
            # this plan's, and not at all when a death declaration is
            # resolving the mapping itself (revert=False).
            if revert and plan.src not in self.dead \
                    and directory.gateway_of_cell(plan.cell_id) == plan.dst:
                version = directory.override_version + 1
                self._apply_directory_local({plan.cell_id: plan.src},
                                            version)
                self._broadcast_directory({plan.cell_id: plan.src}, version)
            if _trace.enabled:
                _trace.instant("ctl.migrate_abort", trace=plan.trace_id)
                _trace.note_anomaly(
                    "global_migration_abort",
                    f"plan {plan.plan_id} cell {plan.cell_id} "
                    f"{plan.src}->{plan.dst}: {result} ({reason})",
                )
        self._event({
            "kind": "migration", "plan": plan.plan_id,
            "cell": plan.cell_id, "src": plan.src, "dst": plan.dst,
            "result": result, "reason": reason, "entities": entities,
            "epoch": self.epoch, "trace": plan.trace_id,
        })
        log = logger.info if result == "committed" else logger.warning
        log(
            "shard migration %d %s (%s): cell %d, %s -> %s, %d entities",
            plan.plan_id, result, reason or "-", plan.cell_id, plan.src,
            plan.dst, entities,
        )

    # ---- source: the drain -----------------------------------------------

    def _on_shard_migrate(self, peer: str, msg) -> None:
        # The leader's directory broadcast rides the same trunk and may
        # land after this message: apply the mapping it carries first —
        # through the lifecycle hook, so if the drain below is refused
        # and the leader dies before reverting, the purge candidate
        # still evacuates our residents to the destination instead of
        # stranding them behind a fleet-wide mapping we no longer hold.
        self._apply_directory_local(
            {msg.channelId: msg.dstGateway}, msg.directoryVersion
        )
        if self._drain is not None:
            self._send_status(peer, msg.planId, "refused",
                              "drain in progress", 0, msg.traceId)
            return
        self._begin_drain(msg.planId, msg.channelId, msg.dstGateway,
                          peer, msg.traceId)

    def _begin_drain(self, plan_id: int, cell_id: int, dst: str,
                     leader: str, trace_id: str) -> None:
        from ..core.channel import get_channel
        from ..core.failover import entity_count_of

        ch = get_channel(cell_id)
        if ch is None or ch.is_removing():
            self._send_status(leader, plan_id, "refused", "no_cell", 0,
                              trace_id)
            return
        self._drain = ShardDrain(
            plan_id=plan_id, cell_id=cell_id, dst=dst, leader=leader,
            trace_id=trace_id, started_epoch=self.epoch,
            entities_at_start=entity_count_of(ch), t0=_trace.now(),
        )
        logger.info(
            "shard drain %d started: cell %d (%d residents) -> gateway %s",
            plan_id, cell_id, self._drain.entities_at_start, dst,
        )
        self._kick_drain()

    def _offerable_residents(self, ch, cid: int,
                             drop_foreign_ledger: bool) -> list[int]:
        """The exactly-once discipline shared by _kick_drain and
        _evacuate_local_cell for shipping a hosted cell's residents
        over the trunk. Rows with an in-flight transaction (local or
        remote) or a parked re-offer resolve on their own. Rows whose
        entity CHANNEL is gone are stale residue — dropped in place, or
        the residual count never reaches zero. The placement ledger
        decides rows whose authoritative cell is elsewhere (a local
        crossing's add hop can commit before its remove hop executes,
        so the cell's data briefly lists an entity that lives
        elsewhere — shipping it would leave the real copy behind as a
        duplicate): a drain leaves them to resolve on their own
        (drop_foreign_ledger=False), an evacuation drops the row too
        (True — the cell itself is going away)."""
        from ..core.channel import get_channel
        from ..core.failover import journal
        from ..spatial.controller import get_spatial_controller

        ledger = getattr(get_spatial_controller(), "_data_cell", {})
        ents = getattr(ch.get_data_message(), "entities", None) or ()
        offer: list[int] = []
        for eid in sorted(ents):
            if journal.pending_dst(eid) is not None \
                    or journal.remote_in_flight(eid) \
                    or eid in self.plane._parked:
                continue
            ech = get_channel(eid)
            foreign = ledger.get(eid, cid) != cid
            if ech is None or ech.is_removing() \
                    or (foreign and drop_foreign_ledger):
                def _drop(c, e=eid):
                    remover = getattr(c.get_data_message(),
                                      "remove_entity", None)
                    if remover is not None:
                        remover(e)

                ch.execute(_drop)
                continue
            if not foreign:
                offer.append(eid)
        return offer

    def _kick_drain(self) -> None:
        from ..core.channel import get_channel

        d = self._drain
        ch = get_channel(d.cell_id)
        if ch is None:
            return
        offer = self._offerable_residents(ch, d.cell_id,
                                          drop_foreign_ledger=False)
        if offer:
            self.plane.initiate_handover(
                d.cell_id, d.cell_id,
                [lambda s, dd, e=eid: e for eid in offer],
            )

    def _advance_drain(self) -> None:
        from ..core.channel import get_channel, remove_channel
        from ..core.failover import entity_count_of, journal

        d = self._drain
        if d is None:
            return
        st = global_settings
        ch = get_channel(d.cell_id)
        if ch is None or ch.is_removing():
            # The cell vanished under the drain (failover raced it).
            self._finish_drain("aborted", "cell_removed")
            return
        if d.refused:
            self._finish_drain("refused", "destination L3")
            return
        residual = entity_count_of(ch)
        in_flight = journal.in_flight_touching(d.cell_id)
        parked = sum(
            1 for p in self.plane._parked.values()
            if p.dst_channel_id == d.cell_id
            or p.src_channel_id == d.cell_id
        )
        if residual == 0 and in_flight == 0 and parked == 0:
            # Authority fully handed over: the local cell channel goes
            # (the directory maps the cell to the destination; crossings
            # into it route over the trunk from now on).
            remove_channel(ch)
            self._finish_drain("committed", "")
            return
        elapsed_ms = (self.epoch - d.started_epoch) * st.global_epoch_ms
        if elapsed_ms > st.global_migrate_timeout_ms:
            self._finish_drain("aborted", "drain timeout")
            return
        if residual and not in_flight:
            self._kick_drain()  # stragglers (e.g. trunk flap) re-offer

    def _finish_drain(self, result: str, reason: str) -> None:
        d = self._drain
        self._drain = None
        # Src-drain span: the middle third of the stitched trace.
        _trace.span("ctl.drain", d.t0, trace=d.trace_id or None)
        self._event({
            "kind": "drain", "plan": d.plan_id, "cell": d.cell_id,
            "dst": d.dst, "result": result, "reason": reason,
            "entities": d.moved, "epoch": self.epoch,
        })
        self._send_status(d.leader, d.plan_id, result, reason, d.moved,
                          d.trace_id)

    def _send_status(self, leader: str, plan_id: int, result: str,
                     reason: str, entities: int, trace_id: str) -> None:
        msg = control_pb2.TrunkMigrateStatusMessage(
            planId=plan_id, result=result, reason=reason,
            entities=entities, traceId=trace_id,
        )
        if leader == directory.local_id:
            self._on_migrate_status(leader, msg)
            return
        link = self.plane.link_to(leader)
        if link is not None:
            link.send(MessageType.TRUNK_MIGRATE_STATUS, msg)

    # ---- directory-driven cell lifecycle ---------------------------------

    def on_directory_update(self, overrides: dict[int, str]) -> None:
        """Runs (inside the GLOBAL tick) after a trunk directory update
        applied: create local channels for cells newly mapped HERE (the
        migration destination's half of the handshake), and mark cells
        mapped AWAY that we still host as purge CANDIDATES (the
        returned-zombie case — the fleet moved on while we were
        partitioned; our copies are stale). Candidates are never purged
        immediately: a planned migration's directory broadcast reaches
        the source moments around its TrunkShardMigrate command, so the
        purge waits a grace period and re-checks — a drain (or a
        reverted override) clears the candidate."""
        from ..core.channel import get_channel

        local = directory.local_id
        for cid, gw in overrides.items():
            ch = get_channel(cid)
            if gw == local:
                self._purge_candidates.pop(cid, None)
                if ch is None or ch.is_removing():
                    self._ensure_local_cell(cid)
            elif ch is not None and not ch.is_removing():
                self._purge_candidates.setdefault(cid, self.epoch)

    def _advance_purges(self) -> None:
        from ..core.channel import get_channel

        r = self._resurrect
        if r is not None and not r["resolved"]:
            # A pending resurrection handshake owns the zombie-cell
            # resolution: the adopter's ack decides which residents
            # hand over and which drop (its copy wins). Evacuating now
            # would ship conflicting copies source-wins — the WRONG
            # direction for a returned corpse. Bounded: past the
            # restart deadline the ordinary evacuation (which never
            # deletes a possibly-only copy) takes over.
            if time.monotonic() < r["deadline"]:
                return
            r["resolved"] = True
            self._count_resurrection("unresolved")
            logger.warning(
                "resurrection handshake unresolved past the %.0fs "
                "restart deadline; falling back to zombie evacuation",
                global_settings.wal_restart_deadline_s,
            )
        for cid, e0 in list(self._purge_candidates.items()):
            if self._drain is not None and self._drain.cell_id == cid:
                # A planned drain owns this cell's teardown.
                del self._purge_candidates[cid]
                continue
            gw = directory.gateway_of_cell(cid)
            ch = get_channel(cid)
            if gw is None or gw == directory.local_id or ch is None \
                    or ch.is_removing():
                del self._purge_candidates[cid]
                continue
            if self.epoch - e0 >= 3 \
                    and self._evacuate_local_cell(cid, ch, gw):
                del self._purge_candidates[cid]

    def _sweep_stale_rows(self) -> None:
        """Defense-in-depth, once per epoch: a cell data row whose
        entity CHANNEL is gone — and that no in-flight transaction or
        parked re-offer is about to resolve — is stale residue (e.g. a
        local crossing's src row leaked under burst load). The census
        counts such a row as a live copy, a migration would ship it as
        one, and the epoch replica would teach an adopter to restore
        it. Same skip/drop discipline as _offerable_residents; runs
        inside the GLOBAL tick, so it never observes a mid-operation
        state."""
        from ..core.channel import get_channel
        from ..core.failover import journal

        for cid, ch in self._local_cell_channels():
            ents = getattr(ch.get_data_message(), "entities", None)
            if not ents:
                continue
            for eid in list(ents):
                if journal.pending_dst(eid) is not None \
                        or journal.remote_in_flight(eid) \
                        or eid in self.plane._parked:
                    continue
                ech = get_channel(eid)
                if ech is None or ech.is_removing():
                    def _drop(c, e=eid):
                        remover = getattr(c.get_data_message(),
                                          "remove_entity", None)
                        if remover is not None:
                            remover(e)

                    ch.execute(_drop)
                    self._note("stale_rows_swept")
                    logger.warning(
                        "stale data row swept: entity %d in cell %d "
                        "has no live entity channel", eid, cid,
                    )

    def _ensure_local_cell(self, cid: int):
        """Create (or re-own) one local spatial cell channel through the
        shared placement path — the migration-destination / adoption
        half of a cell authority move."""
        from ..core.channel import create_channel_with_id, get_channel
        from ..core.failover import collect_spatial_loads, pick_placement
        from ..core.subscription import subscribe_to_channel
        from ..core.subscription_messages import send_subscribed

        ch = get_channel(cid)
        if ch is not None and not ch.is_removing():
            if not ch.has_owner():
                owner = pick_placement(collect_spatial_loads())
                if owner is not None:
                    ch.set_owner(owner)
            return ch
        owner = pick_placement(collect_spatial_loads())
        ch = create_channel_with_id(cid, ChannelType.SPATIAL, owner)
        ch.init_data(None, None)
        if owner is not None:
            opts = control_pb2.ChannelSubscriptionOptions(
                dataAccess=ChannelDataAccess.WRITE_ACCESS,
                skipSelfUpdateFanOut=True, skipFirstFanOut=True,
            )
            cs, should_send = subscribe_to_channel(owner, ch, opts)
            if should_send and cs is not None:
                send_subscribed(owner, ch, owner, 0, cs.options)
        self._note("cells_created")
        return ch

    def _evacuate_local_cell(self, cid: int, ch, new_gw: str) -> bool:
        """The fleet mapped this cell to ``new_gw`` while we still host
        a copy (a returned partition, or a mid-plan death re-map). The
        copies here may be the ONLY live copies — never delete them:
        live residents ship to the directory owner through the ordinary
        trunked transactional handover (the receiver's bounce-back rule
        keeps exactly one copy if it also holds one), rows whose entity
        channel is gone are dropped, and the empty cell is removed.
        Returns True once the cell is gone."""
        from ..core.channel import remove_channel
        from ..core.failover import entity_count_of, journal

        live = self._offerable_residents(ch, cid, drop_foreign_ledger=True)
        if live:
            self._note("zombie_entities_evacuated", len(live))
            self._event({
                "kind": "zombie_evacuate", "cell": cid, "new_gw": new_gw,
                "ids": live, "epoch": self.epoch,
            })
            logger.warning(
                "cell %d re-mapped to gateway %s while hosted here: "
                "evacuating %d live residents over the trunk",
                cid, new_gw, len(live),
            )
            self.plane.initiate_handover(
                cid, cid, [lambda s, d, e=eid: e for eid in live]
            )
            return False  # drain in progress; re-check next epoch
        if entity_count_of(ch) or journal.in_flight_touching(cid):
            return False
        remove_channel(ch)
        self._note("zombie_cells_purged")
        self._event({
            "kind": "zombie_purge", "cell": cid, "new_gw": new_gw,
            "epoch": self.epoch,
        })
        return True

    # ---- resurrection (doc/persistence.md) -------------------------------

    def arm_resurrection(self, wal_replayed: int,
                         restored_entities=()) -> None:
        """Called by the WAL boot replay on a gateway that restarted
        from durable state: announce on every trunk (now and as later
        links come up) with the last persisted directory version and
        the replayed shard census. The handshake resolves to exactly
        one of: *yielded* (the shard was adopted while down — hand the
        adopter the WAL-recovered entities it is missing, drop the
        rest; its copy wins on conflict), *reclaimed* (death was never
        declared — keep serving), or *unresolved* (no peer answered by
        the deadline — fall back to the ordinary zombie-evacuation
        machinery, which never deletes a possibly-only copy)."""
        self._resurrect = {
            "replayed": wal_replayed,
            "announced": set(), "acks": {},
            "resolved": False, "yielded_to": set(),
            # In-flight entities the replay restored via QUEUED re-adds
            # (the src cell's next tick lands them): the census must
            # name them even when the hello beats that tick, or a
            # reclaim peer's fsync-window reconciliation would restore
            # a second copy from its retention.
            "restored": set(restored_entities),
            "deadline": time.monotonic()
            + global_settings.wal_restart_deadline_s,
        }
        self._count_resurrection("announced")
        self._event({"kind": "resurrect_armed", "replayed": wal_replayed})
        if self.active:
            for peer in self.live_peers():
                self._announce_resurrection(peer)

    def _resurrect_census(self) -> tuple[list[int], list[int]]:
        """(hosted cells, resident entity ids) as the replay restored
        them — NOT filtered by the directory: the whole point is that
        the fleet map may have moved on while this gateway was down."""
        from ..core.channel import all_channels

        st = global_settings
        lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start
        cells: list[int] = []
        ents: set[int] = set()
        for cid, ch in all_channels().items():
            if lo <= cid < hi and not ch.is_removing():
                cells.append(cid)
                rows = getattr(ch.get_data_message(), "entities", None)
                if rows:
                    ents.update(rows)
        r = self._resurrect
        if r is not None:
            # Queued in-flight restores whose re-add hasn't ticked yet
            # still belong to the census (their entity channels exist).
            from ..core.channel import get_channel

            ents.update(e for e in r["restored"]
                        if get_channel(e) is not None)
        return sorted(cells), sorted(ents)

    def _announce_resurrection(self, peer: str) -> None:
        r = self._resurrect
        link = self.plane.link_to(peer) if self.plane is not None else None
        if r is None or peer in r["announced"] or link is None:
            return
        cells, ents = self._resurrect_census()
        sent = link.send(
            MessageType.TRUNK_RESURRECT_HELLO,
            control_pb2.TrunkResurrectHelloMessage(
                gatewayId=directory.local_id,
                directoryVersion=directory.override_version,
                cellIds=cells, entityIds=ents,
                walReplayed=r["replayed"],
            ),
        )
        if sent:
            r["announced"].add(peer)
            logger.warning(
                "resurrection hello -> %s: %d cells, %d entities, "
                "directory v%d (%d WAL records replayed)",
                peer, len(cells), len(ents),
                directory.override_version, r["replayed"],
            )

    def _on_resurrect_hello(self, peer: str, msg) -> None:
        if msg.ack:
            self._on_resurrect_ack(peer, msg)
            return
        local = directory.local_id
        # Its shard was adopted iff the fleet map no longer points its
        # census cells at it (the death re-map's overrides) — or we
        # still carry it in the dead set (the trunk-up discard can race
        # a hello coalesced into the same read).
        shard_adopted = peer in self.dead or any(
            directory.gateway_of_cell(c) not in (None, peer)
            for c in msg.cellIds
        )
        reply = control_pb2.TrunkResurrectHelloMessage(
            gatewayId=local, ack=True, shardAdopted=shard_adopted,
            directoryVersion=directory.override_version,
        )
        if shard_adopted and any(
            directory.gateway_of_cell(c) == local for c in msg.cellIds
        ):
            # WE adopted (some of) its cells: name the census entities
            # we do NOT host — the returnee hands exactly those over
            # and drops the rest (our copy wins on conflict).
            reply.isAdopter = True
            reply.missingEntityIds.extend(
                e for e in msg.entityIds if not self._hosts_entity(e)
            )
        self._count_resurrection(
            "peer_yielded" if shard_adopted else "peer_reclaimed"
        )
        # Census reconciliation for the ack-vs-fsync window: a batch we
        # committed INTO the returnee may have been applied and acked
        # there inside its final (never-fsync'd) WAL batch — our copy
        # was torn down on the ack, its copy died with the crash, and on
        # a RECLAIM nothing else would ever restore it (the retained-
        # batch machinery only fires on a death declaration). The hello
        # census names every entity the replay recovered; any retained-
        # batch entity absent from it — and not live anywhere we can
        # see — is restored here from the retained data.
        restored_lost: list[int] = []
        retained = self._retained.get(peer)
        if retained and not shard_adopted:
            census = set(msg.entityIds)
            for batch in list(retained.values()):
                for rec in batch.records:
                    if rec.entity_id in census \
                            or self._hosts_entity(rec.entity_id):
                        continue
                    if self._restore_entity(rec.entity_id, rec.data,
                                            batch.src_channel_id):
                        restored_lost.append(rec.entity_id)
        if restored_lost:
            self._note("resurrect_fsync_window_restored",
                       len(restored_lost))
            logger.warning(
                "resurrection census of %s is missing %d entities we "
                "committed into it (lost to its final fsync window): "
                "restored from commit retention", peer,
                len(restored_lost),
            )
        self._event({
            "kind": "resurrect_hello", "peer": peer,
            "cells": len(msg.cellIds), "entities": len(msg.entityIds),
            "adopted": shard_adopted,
            "missing": list(reply.missingEntityIds),
            "fsync_window_restored": restored_lost,
            "epoch": self.epoch,
        })
        logger.warning(
            "resurrection hello from %s (%d cells, %d entities): shard "
            "%s%s", peer, len(msg.cellIds), len(msg.entityIds),
            "ADOPTED while it was down" if shard_adopted else "intact "
            "(death never declared) — it reclaims",
            f"; {len(reply.missingEntityIds)} entities missing here"
            if reply.isAdopter else "",
        )
        link = self.plane.link_to(peer) if self.plane is not None else None
        if link is not None:
            link.send(MessageType.TRUNK_RESURRECT_HELLO, reply)

    def _on_resurrect_ack(self, peer: str, msg) -> None:
        r = self._resurrect
        if r is None:
            return
        r["acks"][peer] = msg
        if msg.shardAdopted:
            if not r["resolved"]:
                r["resolved"] = True
                self._count_resurrection("yielded")
                self._event({
                    "kind": "resurrect_yielded", "adopter_known": peer,
                    "epoch": self.epoch,
                })
            if msg.isAdopter and peer not in r["yielded_to"]:
                # Every adopter yields independently: post-death
                # migrations can split the shard across several
                # gateways, and each ack names only the cells its
                # sender now owns (_yield_shard filters by the
                # directory) — yielding to just the first would leave
                # the second adopter's cells to fall back to
                # source-wins evacuation, the wrong conflict direction.
                r["yielded_to"].add(peer)
                self._yield_shard(peer, set(msg.missingEntityIds))
        else:
            if not r["resolved"] and r["announced"] \
                    and set(r["acks"]) >= r["announced"]:
                # Every announced peer answered "not adopted": the
                # death was never declared — this gateway keeps its
                # shard and serves on; peers resync through the
                # ordinary epoch machinery.
                r["resolved"] = True
                self._count_resurrection("reclaimed")
                self._event({"kind": "resurrect_reclaimed",
                             "epoch": self.epoch})
                logger.warning(
                    "resurrection resolved: shard RECLAIMED (death was "
                    "never declared; %d peers confirmed)",
                    len(r["acks"]),
                )

    def _yield_shard(self, adopter: str, missing: set[int]) -> None:
        """The returnee's half of a yielded resurrection: for every
        entity in a cell now mapped to the adopter — hand it over the
        trunk when the adopter is missing it (exactly-once via the
        ordinary trunked transactional handover + applied registry),
        drop the local copy when the adopter already holds one (its
        copy wins: it served the entity while we were dead). Emptied
        zombie cells then purge through the normal candidate
        machinery."""
        from ..core.channel import all_channels, get_channel, \
            remove_channel

        st = global_settings
        lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start
        by_cell: dict[int, list[int]] = {}
        dropped: list[int] = []
        for cid, ch in list(all_channels().items()):
            if not (lo <= cid < hi) or ch.is_removing():
                continue
            if directory.gateway_of_cell(cid) != adopter:
                continue
            rows = getattr(ch.get_data_message(), "entities", None) or ()
            for eid in sorted(rows):
                if eid in missing:
                    by_cell.setdefault(cid, []).append(eid)
                else:
                    self.plane._purge_local_placement(eid)
                    ech = get_channel(eid)
                    if ech is not None and not ech.is_removing():
                        remove_channel(ech)
                    dropped.append(eid)
        handed = 0
        for cid, eids in sorted(by_cell.items()):
            handed += len(eids)
            self.plane.initiate_handover(
                cid, cid, [lambda s, d, e=eid: e for eid in eids]
            )
        self._note("resurrect_entities_handed", handed)
        self._note("resurrect_conflicts_dropped", len(dropped))
        self._event({
            "kind": "resurrect_yield_shard", "adopter": adopter,
            "handed": handed, "dropped_ids": dropped,
            "epoch": self.epoch,
        })
        logger.warning(
            "yielding shard to %s: %d WAL-recovered entities handed "
            "over (adopter was missing them), %d conflicting copies "
            "dropped (adopter's copy wins)", adopter, handed,
            len(dropped),
        )

    # ---- death detection + declaration -----------------------------------

    def _check_deaths(self) -> None:
        st = global_settings
        now = time.monotonic()
        window_s = st.global_death_miss_epochs * st.global_epoch_ms / 1000.0
        for peer in directory.peers():
            if peer in self.dead:
                continue
            if self.plane.link_to(peer) is not None:
                self._down_since.pop(peer, None)
                continue
            if peer not in self._seen_up:
                continue  # never had a trunk: boot, not death
            t0 = self._down_since.setdefault(peer, now)
            if peer in self._goodbyes:
                # Graceful goodbye: the silence is announced, not
                # ambiguous — skip the miss window entirely.
                t0 = now - window_s
            # Only the leader declares — computed EXCLUDING the suspect
            # (a dead lowest-id gateway must not stay leader forever).
            survivors = [
                g for g in [directory.local_id] + self.live_peers()
                if g != peer
            ]
            if survivors and min(survivors) == directory.local_id \
                    and now - t0 >= window_s:
                self._declare_dead(peer)

    def _declare_dead(self, peer: str) -> None:
        from ..spatial.controller import get_spatial_controller

        survivors = [
            g for g in [directory.local_id] + self.live_peers()
            if g != peer
        ]
        # Least-loaded survivor adopts, by exported entity count
        # (tie-break lowest id — deterministic).
        adopter = min(
            survivors,
            key=lambda g: (self.vectors.get(g, {}).get("entities", 0), g),
        )
        # Cancel in-flight plans entangled with the corpse BEFORE the
        # directory scan: a plan INTO the dead gateway reverts to its
        # live source (the drain aborts on trunk loss and restores
        # there); a plan OUT of it hands the cell to the adopter below
        # — its replica rows must land where the adoption bootstrap
        # runs, and the destination's partial applied copies evacuate
        # to the adopter through the ordinary trunked handover.
        dead_src_cells: list[int] = []
        for plan in [p for p in list(self._plans.values())
                     if p.src == peer or p.dst == peer]:
            del self._plans[plan.plan_id]
            if plan.dst == peer:
                version = directory.override_version + 1
                self._apply_directory_local({plan.cell_id: plan.src},
                                            version)
                self._broadcast_directory({plan.cell_id: plan.src},
                                          version)
            else:
                dead_src_cells.append(plan.cell_id)
            self._resolve_plan(plan, "aborted", "gateway death", 0,
                               revert=False)
        cells = list(dead_src_cells)
        ctl = get_spatial_controller()
        if ctl is not None and getattr(ctl, "grid_cols", 0):
            start = global_settings.spatial_channel_id_start
            for i in range(ctl.grid_cols * ctl.grid_rows):
                if directory.gateway_of_cell(start + i) == peer \
                        and start + i not in cells:
                    cells.append(start + i)
        trace_id = new_trace_id(f"gdead-{directory.local_id}")
        version = directory.override_version + 1
        self._apply_directory_local({c: adopter for c in cells}, version)
        self._broadcast_directory({c: adopter for c in cells}, version)
        msg = control_pb2.TrunkGatewayDeadMessage(
            deadGateway=peer, adopterGateway=adopter, epoch=self.epoch,
            directoryVersion=version, cellIds=cells, traceId=trace_id,
        )
        for p in self.live_peers():
            link = self.plane.link_to(p)
            if link is not None:
                link.send(MessageType.TRUNK_GATEWAY_DEAD, msg)
        logger.error(
            "gateway %s declared DEAD (trunk silent %d epochs): %d cells "
            "re-assigned to %s at directory v%d",
            peer, global_settings.global_death_miss_epochs, len(cells),
            adopter, version,
        )
        self._process_death(peer, adopter, cells, trace_id)

    def _on_gateway_dead(self, sender: str, msg) -> None:
        self._process_death(
            msg.deadGateway, msg.adopterGateway, list(msg.cellIds),
            msg.traceId,
        )

    def _process_death(self, dead: str, adopter: str, cells: list[int],
                       trace_id: str) -> None:
        """Every survivor runs this exactly once per declaration."""
        if dead in self.dead or dead == directory.local_id:
            return
        from ..core import metrics

        self.dead.add(dead)
        self.deaths += 1
        metrics.gateway_deaths.inc()
        self.vectors.pop(dead, None)
        self._down_since.pop(dead, None)
        self._goodbyes.discard(dead)
        # A drain whose DESTINATION just died can never complete: the
        # leader reverts the cell to us, and without this cancel the
        # drain would park/drop-churn its residents every epoch until
        # the migrate timeout (the leader ignores the stale status; the
        # in-flight batches to the corpse abort on trunk loss and
        # restore here).
        d = self._drain
        if d is not None and d.dst == dead:
            self._finish_drain("aborted", "destination died")
        # A census can't wait on a corpse's claims.
        pa = self._adoption
        if pa is not None and dead in pa.get("awaiting", set()):
            pa["awaiting"].discard(dead)
            if not pa["awaiting"]:
                self._census_advance()
        if _trace.enabled:
            _trace.instant("ctl.gateway_dead", trace=trace_id or None)
            # A gateway death is THE fleet-level anomaly: freeze the
            # timeline that led to the declaration (cooldown-bounded).
            _trace.note_anomaly(
                "gateway_death",
                f"{dead} dead, {len(cells)} cells -> {adopter}",
            )
        candidates = self._resurrection_candidates(dead)
        # Offers whose ADOPTER died before granting: the first dead's
        # candidates ride the dead adopter's census now (its cells —
        # including the ones it adopted — re-map to the new adopter).
        for d0, off in list(self._offered.items()):
            if off["adopter"] == dead:
                del self._offered[d0]
                candidates.extend(
                    (eid, data, src)
                    for eid, (data, src) in sorted(off["cands"].items())
                )
        # Queued abort notices for the dead gateway re-target to the
        # adopter: it installs the dead's applied-batch registry, so the
        # notices purge exactly the entities those batches left behind.
        # (When WE adopt, the aborted entities were restored here — the
        # bootstrap's liveness/claims veto already keeps them singular,
        # so our own queued notices are simply dropped.)
        notices = self.plane._abort_notices.pop(dead, None)
        if notices and adopter != directory.local_id:
            self.plane._abort_notices.setdefault(
                adopter, {}
            ).update(notices)
        # Un-acked redirect stagings toward the dead gateway re-point at
        # the adopter (its replica carries the staged handles).
        for pit, pending in list(self.plane._pending_redirects.items()):
            if pending[3] != dead:
                continue
            del self.plane._pending_redirects[pit]
            conn, entity_id, dst_cid, _p, token, _dl, trace = pending
            self.plane._send_redirect(conn, adopter, entity_id, dst_cid,
                                      token, staged=False, trace=trace)
        self._event({
            "kind": "gateway_dead", "dead": dead, "adopter": adopter,
            "cells": len(cells),
            "resurrection_candidates": [c[0] for c in candidates],
            "epoch": self.epoch, "trace": trace_id,
        })
        if adopter == directory.local_id:
            # A pre-stashed offer for this dead (the adopter's census
            # query raced the leader's death broadcast) joins ours.
            off = self._offered.pop(dead, None)
            if off is not None:
                candidates.extend(
                    (eid, data, src)
                    for eid, (data, src) in sorted(off["cands"].items())
                )
            self._begin_adoption(dead, cells, trace_id, candidates)
        elif candidates:
            # NOT the adopter: never restore unilaterally — a second
            # census racing the adopter's was exactly the
            # duplicate-entity bug. Offer the candidates through the
            # claims reply; the grant (or the fallback deadline if the
            # adopter never resolves) restores them.
            self._stash_offer(dead, adopter, candidates)

    def _resurrection_candidates(self, dead: str) -> list[tuple]:
        """Batches committed INTO the dead gateway whose entities its
        last replica does NOT cover die with it unless the initiator
        restores them — they were torn down here on commit and never
        reached a replicated snapshot. Restoring is deferred behind the
        claims census (an entity that hopped onward off the dead
        gateway in its final window is live on ANOTHER survivor — a
        blind restore would duplicate it)."""
        retained = self._retained.pop(dead, None)
        if not retained:
            return []
        from ..core.channel import get_channel

        covered = self._replica_entity_ids(dead)
        candidates: list[tuple] = []
        for batch in retained.values():
            for rec in batch.records:
                if rec.entity_id in covered:
                    continue  # the adopter's bootstrap recreates it
                ech = get_channel(rec.entity_id)
                if ech is not None and not ech.is_removing():
                    continue  # already back here some other way
                candidates.append(
                    (rec.entity_id, rec.data, batch.src_channel_id)
                )
        return candidates

    def _hosts_entity(self, eid: int) -> bool:
        """Live here in ANY form: a live entity channel, an in-flight
        handover (local or trunked — commit lands it live elsewhere,
        abort restores it here), or a parked crossing awaiting
        re-offer. The census treats every form as claimed: the entity
        resolves to exactly one live copy without the adopter's help —
        bootstrapping or granting it would mint a duplicate."""
        from ..core.channel import get_channel
        from ..core.failover import journal

        ch = get_channel(eid)
        if ch is not None and not ch.is_removing():
            return True
        return (
            journal.pending_dst(eid) is not None
            or journal.remote_in_flight(eid)
            or (self.plane is not None and eid in self.plane._parked)
        )

    def _stash_offer(self, dead: str, adopter: str,
                     candidates: list[tuple]) -> None:
        off = self._offered.setdefault(dead, {
            "adopter": adopter, "cands": {},
            "deadline": time.monotonic()
            + global_settings.global_adopt_claims_timeout_ms * 8 / 1000.0,
        })
        off["adopter"] = adopter
        off["cands"].update(
            {eid: (data, src) for eid, data, src in candidates}
        )

    def _advance_offered(self) -> None:
        """Fallback for a census that never resolves (the adopter went
        silent without dying): restore the offered candidates locally,
        liveness-checked — losing them for good is strictly worse than
        the partition-edge duplicate risk."""
        now = time.monotonic()
        for dead, off in list(self._offered.items()):
            if now <= off["deadline"]:
                continue
            del self._offered[dead]
            restored = [
                eid for eid, (data, src) in sorted(off["cands"].items())
                if not self._hosts_entity(eid)
                and self._restore_entity(eid, data, src)
            ]
            if restored:
                self._note("entities_resurrected", len(restored))
                self._event({
                    "kind": "resurrection_fallback", "dead": dead,
                    "adopter": off["adopter"], "restored_ids": restored,
                    "epoch": self.epoch,
                })
                logger.error(
                    "adopter %s never resolved %s's census: locally "
                    "restored %d offered candidates",
                    off["adopter"], dead, len(restored),
                )

    def _restore_unclaimed(self, pa: dict) -> list[int]:
        """Census complete: restore every resurrection candidate of the
        ADOPTER'S OWN no survivor claimed (and that isn't live or in
        flight here meanwhile)."""
        claimed: set[int] = set()
        for c in pa["claims"].values():
            claimed |= c
        restored: list[int] = []
        for eid, data, src_cell in pa.get("resurrect", []):
            if eid in claimed or self._hosts_entity(eid):
                continue
            if self._restore_entity(eid, data, src_cell):
                restored.append(eid)
        if restored:
            self._note("entities_resurrected", len(restored))
            logger.warning(
                "resurrected %d entities committed into dead gateway %s "
                "after its last replica snapshot", len(restored),
                pa["dead"],
            )
        return restored

    # ---- the adoption ----------------------------------------------------

    def _begin_adoption(self, dead: str, cells: list[int], trace_id: str,
                        candidates: list[tuple]) -> None:
        """The adopter's half of a death declaration. ``candidates``
        are THIS gateway's resurrection candidates (batches it
        committed into the dead gateway after its last replica
        snapshot); they join the census so a survivor's claim vetoes
        a restore the same way it vetoes a bootstrap."""
        replica = self.replicas.get(dead)
        adoption = {
            "dead": dead, "cells": cells, "trace": trace_id,
            "resurrect": list(candidates), "claims": {},
            "peer_cands": {}, "replica": replica, "seq": 1,
            "queried": set(), "awaiting": set(), "t0": _trace.now(),
        }
        if replica is None:
            logger.error(
                "adopting %s's shard with NO local replica (it died "
                "before its first epoch, or ours lagged): counting on "
                "the survivors' forwarded replicas", dead,
            )
        self._start_census(adoption)

    def _start_census(self, adoption: dict) -> None:
        if self._adoption is not None:
            # One census at a time (the claim sets must not interleave);
            # a second death queues behind the first's finalize.
            self._adoption_queue.append(adoption)
            return
        self._adoption = adoption
        adoption["peers"] = [
            p for p in self.live_peers() if p != adoption["dead"]
        ]
        if not adoption["peers"]:
            self._finalize_adoption()
            return
        # Census handshake round 1, ALWAYS run while any peer lives —
        # even with nothing to query: a handover that committed off the
        # dead gateway AFTER its last snapshot left the live copy on a
        # survivor (the stale replica copy must lose), survivors may
        # hold a NEWER replica of the dead than ours, and they may hold
        # resurrection candidates we know nothing about.
        self._send_census_round(sorted(
            self._ids_of_replica(adoption["replica"])
            | {c[0] for c in adoption["resurrect"]}
        ))

    def _send_census_round(self, entity_ids: list[int]) -> None:
        pa = self._adoption
        pa["queried"] |= set(entity_ids)
        pa["awaiting"] = {
            p for p in pa["peers"]
            if p not in self.dead and self.plane.link_to(p) is not None
        }
        pa["deadline"] = (
            time.monotonic()
            + global_settings.global_adopt_claims_timeout_ms / 1000.0
        )
        if not pa["awaiting"]:
            self._finalize_adoption()
            return
        msg = control_pb2.TrunkAdoptQueryMessage(
            deadGateway=pa["dead"], entityIds=entity_ids,
            traceId=pa["trace"], seq=pa["seq"],
        )
        for p in pa["awaiting"]:
            link = self.plane.link_to(p)
            if link is not None:
                link.send(MessageType.TRUNK_ADOPT_QUERY, msg)

    def _on_adopt_query(self, peer: str, msg) -> None:
        """Survivor side of the census: claim what lives (or is in
        flight) here, offer our resurrection candidates, and forward
        our stored replica of the dead — the adopter bootstraps from
        the NEWEST snapshot any survivor holds (a survivor that pruned
        its retained batches against a newer replica than the adopter's
        would otherwise strand those entities: covered there, invisible
        to the adopter, restored by nobody)."""
        dead = msg.deadGateway
        off = self._offered.get(dead)
        if off is None:
            # The query can race the leader's death broadcast: compute
            # and stash the offer now (idempotent — the retained
            # batches pop exactly once).
            cands = self._resurrection_candidates(dead)
            if cands:
                self._stash_offer(dead, peer, cands)
                off = self._offered.get(dead)
        if off is not None:
            off["adopter"] = peer  # the querying adopter grants
        # Claims are a SUPERSET of the queried ids: our replica of the
        # dead may be the newest (the adopter will bootstrap ids the
        # query never listed), and our candidates are censused too.
        ids = set(msg.entityIds) | self._replica_entity_ids(dead)
        if off is not None:
            ids |= set(off["cands"])
        reply = control_pb2.TrunkAdoptClaimsMessage(
            deadGateway=dead, gatewayId=directory.local_id,
            entityIds=[e for e in sorted(ids) if self._hosts_entity(e)],
            seq=msg.seq,
            candidateIds=sorted(off["cands"]) if off is not None else [],
        )
        # The adopter only consults forwarded replicas in round 1 (the
        # choice locks there) — re-sending the full shard snapshot in
        # round 2 would waste trunk bandwidth mid-failover.
        rep = self.replicas.get(dead)
        if rep is not None and msg.seq == 1:
            reply.replica.CopyFrom(rep)
        link = self.plane.link_to(peer)
        if link is not None:
            link.send(MessageType.TRUNK_ADOPT_CLAIMS, reply)

    def _on_adopt_claims(self, peer: str, msg) -> None:
        pa = self._adoption
        if pa is None or pa["dead"] != msg.deadGateway:
            return
        pa["claims"].setdefault(peer, set()).update(msg.entityIds)
        if msg.candidateIds:
            pa["peer_cands"].setdefault(peer, set()).update(
                msg.candidateIds
            )
        if msg.HasField("replica") and pa["seq"] == 1 and (
            pa["replica"] is None
            or msg.replica.epochSeq > pa["replica"].epochSeq
        ):
            # Newest snapshot wins (replicas are broadcast: same
            # epochSeq == same content). The choice locks after round 1
            # — that, plus candidate sets fixed in round 1, bounds the
            # census at two rounds.
            pa["replica"] = msg.replica
        if msg.seq == pa["seq"]:
            pa["awaiting"].discard(peer)
            if not pa["awaiting"]:
                self._census_advance()

    def _census_advance(self) -> None:
        """A census round came back complete. Ids the round revealed —
        a forwarded newer replica's entities, peer candidates — that
        were never queried get ONE more round (every survivor must get
        the chance to claim anything the adopter might restore), then
        the census finalizes."""
        pa = self._adoption
        full = self._ids_of_replica(pa["replica"]) \
            | {c[0] for c in pa["resurrect"]}
        for cs in pa["peer_cands"].values():
            full |= cs
        missing = sorted(full - pa["queried"])
        if missing and pa["seq"] == 1:
            pa["seq"] = 2
            self._send_census_round(missing)
            return
        self._finalize_adoption()

    def _check_adoption_deadline(self) -> None:
        pa = self._adoption
        if pa is not None and time.monotonic() > pa["deadline"]:
            # Proceed with the claims in hand; a silent survivor's
            # claims resolve later through the abort-notice machinery.
            pa["awaiting"].clear()
            self._finalize_adoption()

    def _finalize_adoption(self) -> None:
        from ..core import metrics
        from ..core.channel import get_channel
        from ..core.connection_recovery import stage_recovery_handle

        pa, self._adoption = self._adoption, None
        if pa is None:
            return
        try:
            self._finalize_census(pa, metrics, get_channel,
                                  stage_recovery_handle)
        finally:
            if self._adoption is None and self._adoption_queue:
                self._start_census(self._adoption_queue.pop(0))

    def _finalize_census(self, pa: dict, metrics, get_channel,
                         stage_recovery_handle) -> None:
        dead = pa["dead"]
        trace = pa["trace"]
        replica = pa["replica"]
        claimed: set[int] = set()
        for c in pa["claims"].values():
            claimed |= c
        txn_eids: set[int] = set()
        if replica is not None:
            for txn in replica.txns:
                txn_eids.update(e.entityId for e in txn.entities)
        created_cells = staged = 0
        adopted_ids: list[int] = []
        replayed_ids: list[int] = []
        for cid in pa["cells"]:
            if self._ensure_local_cell(cid) is not None:
                created_cells += 1
        if replica is not None:
            # 1. Cell bootstrap from the packed replica state, minus the
            #    claimed / locally-live / in-flight entities.
            for rc in replica.cells:
                state_of = {}
                if rc.data.type_url:
                    try:
                        cell_data = unpack_any(rc.data)
                        state_of = dict(getattr(cell_data, "entities",
                                                {}).items())
                    except (KeyError, ValueError) as err:
                        logger.error(
                            "replica cell %d of %s undecodable (%s); "
                            "adopting its census without state",
                            rc.channelId, dead, err,
                        )
                for eid in rc.entityIds:
                    if eid in claimed or eid in txn_eids:
                        continue
                    ech = get_channel(eid)
                    if ech is not None and not ech.is_removing():
                        continue  # live local copy wins
                    if self._restore_entity(
                        eid, self._entity_data_from_state(eid,
                                                          state_of.get(eid)),
                        rc.channelId,
                    ):
                        adopted_ids.append(eid)
            # 2. Journal replay, source-wins: in-flight outbound batches
            #    belong to the dead gateway's shard — restore to src,
            #    purge wherever the prepare may have landed.
            for txn in replica.txns:
                if txn.peer == directory.local_id:
                    # The in-flight batch was aimed HERE. If its
                    # prepare landed, our applied copy IS the entity —
                    # the batch effectively committed (the dead source
                    # tore its copy down at prepare), and rolling it
                    # back to the source cell would land it on this
                    # same gateway anyway. Worse, the purge/restore
                    # pair RACES a copy that is mid-local-crossing: the
                    # hosts-veto below skips the restore ("resolves
                    # locally") while the deferred purge then eats that
                    # very copy once its hop lands — the entity
                    # vanishes. Keep the applied copy; the restore
                    # below only fires when the prepare never arrived.
                    pass
                elif txn.peer and txn.peer != dead:
                    # Queued under the DEAD initiator's id: the
                    # destination's applied registry keys this batch
                    # (dead, batchId) — our own id would miss it.
                    # (txn.peer == dead is a LOCAL hop of the dead
                    # gateway: there is no destination to notice.)
                    self.plane._abort_notices.setdefault(
                        txn.peer, {}
                    )[(dead, txn.batchId)] = time.monotonic()
                    link = self.plane.link_to(txn.peer)
                    if link is not None:
                        self.plane._flush_abort_notices(txn.peer, link)
                for e in txn.entities:
                    # A claim by the batch's own destination does NOT
                    # veto the replay: the abort notice above purges
                    # that copy, and source-wins restores here. But an
                    # entity that hopped ONWARD off the destination
                    # after the snapshot is claimed by some OTHER
                    # survivor the notice can't reach (the dst's purge
                    # no-ops on a channel that moved on) — and one
                    # that's live or in flight HERE already resolves
                    # locally. Restoring either would duplicate it.
                    if self._hosts_entity(e.entityId) or any(
                        e.entityId in c
                        for p, c in pa["claims"].items() if p != txn.peer
                    ):
                        continue
                    data = None
                    if e.data.type_url:
                        try:
                            data = unpack_any(e.data)
                        except (KeyError, ValueError):
                            data = None
                    if self._restore_entity(e.entityId, data,
                                            txn.srcChannelId):
                        replayed_ids.append(e.entityId)
            # 3. The dead RECEIVER's applied-batch registry: initiators
            #    that aborted toward the dead gateway keep re-flushing
            #    abort notices (now re-targeted here) — honoring them
            #    needs the batch -> entities map.
            for ra in replica.applied:
                # Keyed by the batch's INITIATOR (per-initiator id
                # spaces — a bare id would collide with our own applied
                # registry and a later notice would purge the WRONG
                # batch's entities).
                key = (ra.peer, ra.batchId)
                if key not in self.plane._applied:
                    self.plane._applied[key] = (0, list(ra.entityIds))
            # The registry bound holds through the install too — the
            # prepare path only trims lazily, and a quiet adopter could
            # otherwise sit at double the cap indefinitely.
            from .plane import MAX_APPLIED_BATCHES

            while len(self.plane._applied) > MAX_APPLIED_BATCHES:
                self.plane._applied.popitem(last=False)
            # 4. Staged recovery handles (in-flight redirects AND the
            #    dead gateway's live client sessions): re-staged here so
            #    those clients resume without re-auth.
            for h in replica.handles:
                cids = [c for c in h.channelIds
                        if get_channel(c) is not None]
                try:
                    stage_recovery_handle(h.pit, cids)
                except RuntimeError as err:
                    logger.warning(
                        "adoption staging for %s failed: %s", h.pit, err
                    )
                    continue
                staged += 1
            # 5. The dead gateway's sensor-scope standing queries
            #    (spatial/queryplane.py): re-registered on THIS
            #    gateway's query plane so server sensors survive their
            #    host's death the way staged handles do. Keys collide
            #    by design — a sensor already registered here (e.g. a
            #    second adoption of the same replica) re-installs onto
            #    its existing engine row, not a duplicate.
            if replica.queries:
                from ..spatial.queryplane import restore_registrations

                q_restored, _q_dropped = restore_registrations(
                    [(q.key, q.scope, q.name, q.kind, list(q.params),
                      list(q.spotDists)) for q in replica.queries],
                    source="adoption",
                )
                if q_restored:
                    self._note("queries_adopted", q_restored)
        # The adopter's own resurrection candidates (committed INTO the
        # dead gateway, never replicated back) restore here too, census
        # vetoed like everything else.
        restored_ids = self._restore_unclaimed(pa)
        adopted = len(adopted_ids)
        replayed = len(replayed_ids)
        # Grants: peer-offered resurrection candidates that nobody
        # claimed and this adoption didn't already restore. The data
        # lives with the offerer — the grant names the ids, the offerer
        # restores. Each id goes to exactly ONE offerer (lowest gateway
        # id when two offered the same entity), so the fleet ends with
        # exactly one live copy.
        restored_here = set(adopted_ids) | set(replayed_ids) \
            | set(restored_ids)
        granted: dict[str, list[int]] = {}
        granted_ids: set[int] = set()
        for p in sorted(pa["peer_cands"]):
            for eid in sorted(pa["peer_cands"][p]):
                if eid in claimed or eid in txn_eids \
                        or eid in restored_here or eid in granted_ids \
                        or self._hosts_entity(eid):
                    continue
                granted.setdefault(p, []).append(eid)
                granted_ids.add(eid)
        self.adoptions += 1
        metrics.gateway_adoptions.inc()
        self._note("entities_adopted", adopted)
        self._note("entities_replayed", replayed)
        self._note("handles_staged", staged)
        _trace.span("ctl.adopt", pa["t0"], trace=trace or None)
        for p in self.live_peers():
            link = self.plane.link_to(p)
            if link is not None:
                link.send(
                    MessageType.TRUNK_ADOPT_DONE,
                    control_pb2.TrunkAdoptDoneMessage(
                        deadGateway=dead,
                        adopterGateway=directory.local_id,
                        cells=created_cells, entities=adopted + replayed,
                        handles=staged, traceId=trace,
                        restoreEntityIds=granted.get(p, []),
                    ),
                )
        self._event({
            "kind": "adoption", "dead": dead, "cells": created_cells,
            "entities_adopted": adopted, "entities_replayed": replayed,
            "handles_staged": staged, "claimed_elsewhere": len(claimed),
            "adopted_ids": adopted_ids, "replayed_ids": replayed_ids,
            "resurrected_ids": restored_ids,
            "granted": {p: ids for p, ids in granted.items()},
            "claims": {p: sorted(c) for p, c in pa["claims"].items()},
            "epoch": self.epoch, "trace": trace,
        })
        logger.warning(
            "adopted gateway %s's shard: %d cells, %d entities "
            "bootstrapped + %d journal-replayed (source-wins) + %d "
            "resurrected, %d claimed by survivors, %d handles staged",
            dead, created_cells, adopted, replayed, len(restored_ids),
            len(claimed), staged,
        )
        self._drop_replica(dead)  # spent: the shard lives here now

    def _entity_data_from_state(self, entity_id: int, state):
        """Rebuild an ENTITY channel data message from the replica cell
        state row (the cell data holds per-entity STATE, the entity
        channel holds the wrapping data message)."""
        from ..core.data import reflect_channel_data_message

        if state is None:
            return None
        proto = reflect_channel_data_message(ChannelType.ENTITY)
        if proto is None or not hasattr(proto, "state"):
            return None
        d = type(proto)()
        d.state.CopyFrom(state)
        return d

    def _restore_entity(self, entity_id: int, data, cell_id: int) -> bool:
        """Recreate one entity (channel + placement in cell_id's data +
        device tracking) — shared by adoption bootstrap, journal replay
        and committed-batch resurrection."""
        from ..core.channel import create_entity_channel, get_channel
        from ..spatial.controller import get_spatial_controller

        ch = get_channel(cell_id)
        if ch is None or ch.is_removing():
            self._note("entities_stranded")
            return False
        if entity_id < global_settings.entity_channel_id_start:
            return False
        ech = get_channel(entity_id)
        if ech is None or ech.is_removing():
            owner = ch.get_owner()
            ech = create_entity_channel(entity_id, owner)
            if data is not None:
                ech.init_data(data, None)
            ctl = get_spatial_controller()
            if ctl is not None:
                ech.spatial_notifier = ctl

        def _add(c, e=entity_id, d=data):
            adder = getattr(c.get_data_message(), "add_entity", None)
            if adder is not None and d is not None:
                adder(e, d)

        ch.execute(_add)
        ctl = get_spatial_controller()
        if ctl is not None:
            tracker = getattr(ctl, "track_entity", None)
            if tracker is not None and hasattr(ctl, "_cell_center"):
                center = ctl._cell_center(
                    cell_id - global_settings.spatial_channel_id_start
                )
                tracker(entity_id, center)
            moved_hook = getattr(ctl, "_note_entity_data_moved", None)
            if moved_hook is not None:
                moved_hook([entity_id], cell_id)
        return True

    def _on_adopt_done(self, peer: str, msg) -> None:
        """Survivor side of the census resolution: the adopter named
        which of our offered resurrection candidates WE restore
        (``restoreEntityIds``) — everything else in the offer was
        claimed, bootstrapped, or replayed elsewhere and gets dropped.
        Popping the offer also stops the fallback-deadline clock."""
        dead = msg.deadGateway
        off = self._offered.pop(dead, None)
        restored: list[int] = []
        if off is not None:
            for eid in msg.restoreEntityIds:
                ent = off["cands"].get(eid)
                if ent is None or self._hosts_entity(eid):
                    continue
                data, src_cell = ent
                if self._restore_entity(eid, data, src_cell):
                    restored.append(eid)
            if restored:
                self._note("entities_resurrected", len(restored))
                logger.warning(
                    "adopter %s granted %d of %d offered candidates of "
                    "dead gateway %s: restored locally",
                    msg.adopterGateway, len(restored),
                    len(off["cands"]), dead,
                )
        self._event({
            "kind": "adopt_done", "dead": dead,
            "adopter": msg.adopterGateway, "cells": msg.cells,
            "entities": msg.entities, "handles": msg.handles,
            "granted": list(msg.restoreEntityIds),
            "restored_ids": restored, "epoch": self.epoch,
        })
        # The census is resolved; our copy of the dead's replica (it
        # was forwarded in the claims reply) is spent.
        self._drop_replica(dead)

    # ---- trunk dispatch --------------------------------------------------

    def on_trunk_message(self, peer: str, msg_type: int, msg) -> bool:
        """Routed from the federation plane's trunk dispatch, already
        inside the GLOBAL tick. True = handled."""
        if not self.active:
            return msg_type in (
                MessageType.TRUNK_LOAD_REPORT,
                MessageType.TRUNK_SHARD_EPOCH,
                MessageType.TRUNK_SHARD_MIGRATE,
                MessageType.TRUNK_MIGRATE_STATUS,
                MessageType.TRUNK_GATEWAY_DEAD,
                MessageType.TRUNK_ADOPT_DONE,
                MessageType.TRUNK_ADOPT_QUERY,
                MessageType.TRUNK_ADOPT_CLAIMS,
                MessageType.TRUNK_RESURRECT_HELLO,
            )
        if msg_type == MessageType.TRUNK_LOAD_REPORT:
            self.vectors[msg.gatewayId or peer] = {
                "gateway": msg.gatewayId or peer,
                "epoch": msg.epoch,
                "pressure": msg.pressure,
                "level": msg.overloadLevel,
                "entities": msg.entities,
                "cells": msg.cells,
                "crossing_rate": msg.crossingRate,
                "trunk_rtt_ms": msg.trunkRttMs,
                "blocks": dict(zip(msg.blockIndices, msg.blockEntities)),
                "directory_version": msg.directoryVersion,
                "geometry_epoch": msg.geometryEpoch,
            }
            if msg.metricsJson:
                from .obs import fleet

                fleet.store_peer(msg.gatewayId or peer, msg.metricsJson)
        elif msg_type == MessageType.TRUNK_SHARD_EPOCH:
            self._on_shard_epoch(peer, msg)
        elif msg_type == MessageType.TRUNK_SHARD_MIGRATE:
            self._on_shard_migrate(peer, msg)
        elif msg_type == MessageType.TRUNK_MIGRATE_STATUS:
            self._on_migrate_status(peer, msg)
        elif msg_type == MessageType.TRUNK_GATEWAY_DEAD:
            self._on_gateway_dead(peer, msg)
        elif msg_type == MessageType.TRUNK_ADOPT_QUERY:
            self._on_adopt_query(peer, msg)
        elif msg_type == MessageType.TRUNK_ADOPT_CLAIMS:
            self._on_adopt_claims(peer, msg)
        elif msg_type == MessageType.TRUNK_ADOPT_DONE:
            self._on_adopt_done(peer, msg)
        elif msg_type == MessageType.TRUNK_RESURRECT_HELLO:
            self._on_resurrect_hello(peer, msg)
        else:
            return False
        return True

    # ---- reporting -------------------------------------------------------

    def report(self) -> dict:
        return {
            "active": self.active,
            "epoch": self.epoch,
            "leader": self.leader() if self.active else "",
            "dead": sorted(self.dead),
            "imbalance": round(self.imbalance, 4),
            "vectors": {g: dict(v) for g, v in self.vectors.items()},
            "ledger": dict(self.ledger),
            "resurrections": dict(self.resurrections),
            "adoptions": self.adoptions,
            "deaths": self.deaths,
            "counters": dict(self.counters),
            "retained": {
                p: len(r) for p, r in self._retained.items() if r
            },
            "replica_peers": sorted(self.replicas),
            "events": list(self.events),
        }


control = GlobalControlPlane()


def reset_global_control() -> None:
    """Test hook (also the disarm path, via reset_federation)."""
    control.stop()
    control.reset()
