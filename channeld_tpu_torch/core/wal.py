"""Durable write-ahead journal: crash-consistent gateway persistence.

Beyond-reference capability (the reference has no persistence; SURVEY
§5). The periodic snapshot (core/snapshot.py) bounds data loss to one
snapshot *interval*; this plane bounds it to one fsync *batch*, in the
transactional-durability tradition of geo-replicated stores (PAPERS.md:
Spider). Every authoritative state transition between snapshots appends
one CRC-framed record to an append-only journal:

- **channel_state** — coalesced per-GLOBAL-tick images of every channel
  whose data changed that tick, packed through the same
  ``pack_channel_state`` path snapshots use (what a replay restores and
  what a snapshot would have written are byte-identical by
  construction); **channel_removed** tombstones.
- **journal / batch / batch_done / applied** — the handover journal's
  prepare/commit/abort transitions (core/failover.py), remote-batch
  grouping + terminal results, and the receiver-side applied-batch
  registry (federation/plane.py) — the source-wins reconciliation
  material a crash must not lose.
- **flip** — ``_data_cell`` placement-ledger moves (spatial/grid.py).
- **staged_handle / directory / blacklist** — pre-staged client
  recovery handles, shard-directory override versions, and anti-DDoS
  bans.

**The tick path never blocks.** ``append`` assigns a sequence number
and enqueues; a dedicated writer THREAD drains the queue on an
``wal_fsync_ms`` batch window, frames each record as
``[len u32][crc32 u32][payload]``, writes, and fsyncs once per batch
(``wal_fsync_ms`` histogram — the RPO of a kill -9). tpulint's
async-blocking and hot-path scope tables cover this module: file I/O
and fsync exist only on the writer thread.

**Checkpointing.** Each snapshot stamps the journal sequence it covers
(``GatewaySnapshot.walSeq``) and then truncates records at or below it
(space reclamation — correctness never depends on the truncation
because replay filters by ``walSeq``, which also resolves the
snapshot-newer-than-WAL ordering when an unsynchronized writer — e.g.
the device guard's fatal-entry snapshot — raced the journal).

**Boot replay** (:func:`boot_replay`): restore the snapshot, scan the
journal (a torn final record — power loss mid-append — is tolerated by
truncating at the first bad CRC), fold records last-wins, apply channel
images, re-seed the spatial controller's placement ledger and device
tracking, re-stage recovery handles, restore the directory version and
blacklists, install the applied-batch registry, and resolve in-flight
handover transactions exactly the way failover does: restore to the
src cell (unless a replayed cell image already holds the row) and
queue source-wins abort notices at each remote batch's destination.
If the federation plane is armed, the replay arms the **resurrection
protocol** (federation/control.py): the restarted gateway announces
itself on every trunk with its last directory version and shard census
and either yields its shard to the adopter (handing over exactly the
WAL-recovered entities the adopter is missing — the adopter's copy
wins on conflict) or reclaims it when death was never declared.

Chaos points (doc/chaos.md): ``wal.torn_write`` writes only a prefix
of a record and wedges the writer (power loss mid-append — nothing
after the tear reaches disk); ``wal.fsync_stall`` stalls the writer
before fsync (the tick path must stay unaffected).

Double-entry: ``wal_records_total{kind}`` / ``wal_replayed_total{kind}``
mirror the python ledgers ``record_counts`` / ``replay_counts`` exactly
(the crash soak asserts it on every gateway).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np

from ..chaos.injector import chaos as _chaos
from ..protocol import wal_pb2
from ..utils.anyutil import pack_any, unpack_any
from ..utils.logger import get_logger
from .affinity import affinity as _affinity
from .settings import global_settings
from .types import ChannelType, GLOBAL_CHANNEL_ID

logger = get_logger("wal")

MAGIC = b"CHWAL1\n\x00"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)


def _frame_record(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def read_wal_records(path: str, truncate: bool = True):
    """Scan a journal file: returns ``(records, torn)`` where ``torn``
    is True when the file ended in a partial or CRC-bad record (power
    loss mid-append). Everything before the first bad frame is good —
    frames after a tear are unrecoverable by construction, so the file
    is truncated at the tear (when ``truncate``) and replay proceeds
    with the committed prefix. A zero-length or missing file is an
    empty journal, not an error."""
    records: list = []
    torn = False
    if not os.path.exists(path):
        return records, torn
    with open(path, "rb") as f:
        blob = f.read()
    if not blob:
        return records, torn
    if not blob.startswith(MAGIC):
        logger.error("WAL %s has no magic header; ignoring the file", path)
        return records, True
    off = len(MAGIC)
    good_end = off
    while off < len(blob):
        if off + _FRAME.size > len(blob):
            torn = True
            break
        length, crc = _FRAME.unpack_from(blob, off)
        payload = blob[off + _FRAME.size: off + _FRAME.size + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            torn = True
            break
        rec = wal_pb2.WalRecord()
        try:
            rec.ParseFromString(payload)
        except Exception:
            # A CRC-clean but unparseable record is corruption past the
            # framing layer: same resolution, truncate at it.
            torn = True
            break
        records.append(rec)
        off += _FRAME.size + length
        good_end = off
    if torn and truncate and good_end < len(blob):
        logger.warning(
            "WAL %s torn at byte %d/%d: replaying %d records, truncating "
            "the tail", path, good_end, len(blob), len(records),
        )
        with open(path, "r+b") as f:
            f.truncate(good_end)
    return records, torn


class WriteAheadLog:
    """The process-wide journal (``wal``). Disarmed by default: every
    hook is one attribute load (``wal.enabled``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # Cross-thread state (doc/concurrency.md): the queue hands
        # records from the loop to the writer under self._lock; the
        # enabled/_wedged flags are GIL-atomic bool stores the writer
        # flips on death/power-loss and the loop reads per hook.
        self.enabled = False  # tpulint: shared=atomic
        self.path = ""
        self._seq = 0
        self._dirty: set[int] = set()
        self._queue: list = []  # tpulint: shared=lock
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._wedged = False  # chaos torn_write: died mid-append  # tpulint: shared=atomic
        self._flushed_seq = 0  # last seq fsync'd to disk
        # Python-side ledgers; must match wal_records_total{kind} /
        # wal_replayed_total{kind} exactly.
        self.record_counts: dict[str, int] = {}
        self.replay_counts: dict[str, int] = {}
        self.torn_tails = 0

    # ---- accounting ------------------------------------------------------

    def _count_record(self, kind: str, n: int = 1) -> None:
        self.record_counts[kind] = self.record_counts.get(kind, 0) + n
        from . import metrics

        metrics.wal_records.labels(kind=kind).inc(n)

    def _count_replayed(self, kind: str, n: int = 1) -> None:
        self.replay_counts[kind] = self.replay_counts.get(kind, 0) + n
        from . import metrics

        metrics.wal_replayed.labels(kind=kind).inc(n)

    # ---- lifecycle -------------------------------------------------------

    def start(self, path: str, initial_seq: int = 0) -> None:
        """Arm the journal and start the off-thread writer. ``initial_seq``
        continues numbering above everything replay observed, so new
        records can never be mistaken for snapshot-covered ones."""
        self.path = path
        self._seq = max(self._seq, initial_seq)
        self._stopping = False
        self._wedged = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        if not fresh:
            with open(path, "rb") as f:
                if f.read(len(MAGIC)) != MAGIC:
                    # A headerless/corrupt file would swallow every
                    # future append (replay ignores the whole file):
                    # set it aside and start a fresh journal instead of
                    # a permanent durability black hole.
                    quarantine = f"{path}.corrupt.{os.getpid()}"
                    os.replace(path, quarantine)
                    logger.error(
                        "WAL %s has a corrupt header; quarantined to %s "
                        "and starting a fresh journal", path, quarantine,
                    )
                    fresh = True
        if fresh:
            with open(path, "wb") as f:
                f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
        self._thread = threading.Thread(
            target=self._writer_loop, name="wal-writer", daemon=True
        )
        self.enabled = True
        self._thread.start()
        logger.info(
            "WAL armed at %s (fsync batch %.0fms, seq from %d)",
            path, global_settings.wal_fsync_ms, self._seq,
        )

    def stop(self, flush: bool = True) -> None:
        if self._thread is None:
            self.enabled = False
            return
        if flush:
            self.flush()
        with self._lock:
            self._stopping = True
            self.enabled = False
            self._wake.notify_all()
        self._thread.join(timeout=5.0)
        self._thread = None

    # ---- the append surface (loop thread; never blocks on I/O) ----------

    def current_seq(self) -> int:
        return self._seq

    def writer_alive(self) -> bool:
        """Readiness probe surface (core/opshttp.py /readyz): the
        journal is armed AND its writer thread is live and not wedged —
        anything else means appends are no longer becoming durable."""
        return (self.enabled and not self._wedged
                and self._thread is not None and self._thread.is_alive())

    def append(self, kind: str, rec) -> int:
        """Assign a sequence number, enqueue for the writer, count. The
        ONLY I/O here is a list append under a lock — the framing,
        write and fsync all happen on the writer thread."""
        # Affinity: append is the loop's half of the queue handoff —
        # the writer must never append (it would journal its own work).
        _affinity.expect("tick-loop")
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            rec.kind = kind
            self._queue.append(rec)
            self._wake.notify_all()
            seq = self._seq
        self._count_record(kind)
        return seq

    def note_dirty(self, channel_id: int) -> None:
        """A channel's data changed this tick (called from the channel's
        own tick, post-mutation). Coalesced: the GLOBAL tick drains the
        set into one channel_state record per dirty channel."""
        self._dirty.add(channel_id)

    def on_global_tick(self) -> None:
        """Drain the dirty set into channel_state / channel_removed
        records — runs inside the GLOBAL channel tick, the same context
        the epoch replica packs cell state in. Packing here (not on the
        writer thread) keeps channel state single-writer."""
        if not self._dirty:
            return
        _affinity.expect("tick-loop")
        from .channel import get_channel
        from .snapshot import pack_channel_state

        dirty, self._dirty = self._dirty, set()
        for cid in dirty:
            if cid == GLOBAL_CHANNEL_ID:
                continue  # GLOBAL always exists post-init; never restored
            ch = get_channel(cid)
            if ch is None or ch.is_removing():
                self.append("channel_removed",
                            wal_pb2.WalRecord(channelId=cid))
                continue
            rec = wal_pb2.WalRecord(
                channelId=cid, channelType=int(ch.channel_type),
                metadata=ch.metadata,
            )
            packed = pack_channel_state(ch)
            if packed is not None:
                rec.data.CopyFrom(packed)
                if ch.data.merge_options is not None:
                    rec.mergeOptions.CopyFrom(ch.data.merge_options)
            self.append("channel_state", rec)

    # ---- typed log helpers (the hook surface) ----------------------------

    def log_channel_removed(self, channel_id: int) -> None:
        self._dirty.discard(channel_id)
        self.append("channel_removed", wal_pb2.WalRecord(channelId=channel_id))

    def log_journal(self, op: str, rec) -> None:
        """One handover-journal transition (rec is a HandoverRecord)."""
        w = wal_pb2.WalRecord(
            op=op, txnId=rec.txn_id, entityId=rec.entity_id,
            srcChannelId=rec.src_channel_id, dstChannelId=rec.dst_channel_id,
            remote=rec.remote,
        )
        if op == "prepared" and rec.data is not None:
            w.data.CopyFrom(pack_any(rec.data))
        self.append("journal", w)

    def log_batch(self, batch_id: int, peer: str, entity_ids) -> None:
        self.append("batch", wal_pb2.WalRecord(
            batchId=batch_id, peer=peer, entityIds=list(entity_ids),
        ))

    def log_batch_done(self, batch_id: int, peer: str, op: str) -> None:
        self.append("batch_done", wal_pb2.WalRecord(
            batchId=batch_id, peer=peer, op=op,
        ))

    def log_applied(self, initiator: str, batch_id: int,
                    dst_channel_id: int, entity_ids) -> None:
        self.append("applied", wal_pb2.WalRecord(
            peer=initiator, batchId=batch_id, dstChannelId=dst_channel_id,
            entityIds=list(entity_ids),
        ))

    def log_flip(self, entity_ids, dst_channel_id: int) -> None:
        self.append("flip", wal_pb2.WalRecord(
            entityIds=list(entity_ids), dstChannelId=dst_channel_id,
        ))

    def log_staged_handle(self, pit: str, channel_ids) -> None:
        self.append("staged_handle", wal_pb2.WalRecord(
            pit=pit, handleChannelIds=list(channel_ids),
        ))

    def log_directory(self, version: int, overrides: dict) -> None:
        w = wal_pb2.WalRecord(directoryVersion=version)
        for cid, gw in sorted(overrides.items()):
            w.overrideCells.append(cid)
            w.overrideGateways.append(gw)
        self.append("directory", w)

    def log_geometry(self, epoch: int, splits) -> None:
        """One record per geometry epoch bump (adaptive partitioning,
        spatial/partition.py): the full split set, last record wins at
        replay. Written BEFORE any mutation the split/merge implies —
        this record IS the transaction's commit point."""
        self.append("geometry", wal_pb2.WalRecord(
            geometryEpoch=epoch, splitCells=sorted(splits),
        ))

    def log_sim_census(self, sim_tick: int, seed: int, ids, pos, vel,
                       state, target) -> None:
        """One agent census from the sim plane (channeld_tpu/sim,
        doc/simulation.md): the population's exact kinematic state at
        ``sim_tick``, packed as x,y,z triples parallel to ``ids``. Last
        record wins at replay — seed + tick + census restore the exact
        population and the counter-based RNG resumes the identical
        trajectory (0 lost/duped across a kill -9).

        All array inputs are HOST numpy already (the census arrives
        prefetched; the plane slices before calling) — the ravel/tolist
        below reshape host memory, they transfer nothing."""
        self.append("sim_census", wal_pb2.WalRecord(
            simTick=sim_tick, simSeed=seed & 0xFFFFFFFF,
            simAgentIds=np.asarray(ids, np.uint32).tolist(),  # tpulint: disable=hot-readback -- host numpy in (see docstring); shaping, not a transfer
            simAgentPos=np.asarray(pos, np.float32).ravel().tolist(),  # tpulint: disable=hot-readback -- host numpy in (see docstring); shaping, not a transfer
            simAgentVel=np.asarray(vel, np.float32).ravel().tolist(),  # tpulint: disable=hot-readback -- host numpy in (see docstring); shaping, not a transfer
            simAgentState=np.asarray(state, np.int32).tolist(),  # tpulint: disable=hot-readback -- host numpy in (see docstring); shaping, not a transfer
            simAgentTarget=np.asarray(target, np.float32).ravel().tolist(),  # tpulint: disable=hot-readback -- host numpy in (see docstring); shaping, not a transfer
        ))

    def log_blacklist(self, kind: str, key: str) -> None:
        self.append("blacklist", wal_pb2.WalRecord(
            blacklistKind=kind, blacklistKey=key,
        ))

    def log_query(self, op: str, key: int, scope: str, name: str,
                  kind: int, params, spot_dists) -> None:
        """One standing-query registration transition (op = set |
        remove) on the device query plane (spatial/queryplane.py);
        last record per key wins at replay."""
        self.append("query", wal_pb2.WalRecord(
            op=op, queryKey=key, queryScope=scope, queryName=name,
            queryKind=kind, queryParams=list(params),
            querySpotDists=list(spot_dists),
        ))

    # ---- durability barrier / checkpoint ---------------------------------

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until everything appended so far is fsync'd (test/soak
        barrier and the shutdown drain; NEVER called on the tick path —
        tpulint's scope tables pin that)."""
        target = self._seq
        deadline = time.monotonic() + timeout_s
        with self._lock:
            self._wake.notify_all()
        while time.monotonic() < deadline:
            if self._flushed_seq >= target or self._wedged \
                    or self._thread is None:
                return True
            time.sleep(0.002)
        return False

    def checkpoint(self, cutoff_seq: int) -> None:
        """A snapshot covering every record at or below ``cutoff_seq``
        landed durably: truncate them (enqueued; the writer rewrites the
        file keeping only newer records). Pure space reclamation —
        replay correctness rides the snapshot's walSeq stamp."""
        if not self.enabled or cutoff_seq <= 0:
            return
        with self._lock:
            self._queue.append(("checkpoint", cutoff_seq))
            self._wake.notify_all()

    # ---- the writer thread ----------------------------------------------

    def _writer_loop(self) -> None:
        _affinity.enter("wal-writer")
        try:
            f = open(self.path, "ab")
        except OSError:
            logger.exception("WAL writer cannot open %s; disabled",
                             self.path)
            self.enabled = False
            return
        from . import metrics

        batch_s = max(global_settings.wal_fsync_ms, 0.0) / 1000.0
        try:
            while True:
                with self._lock:
                    while not self._queue and not self._stopping:
                        self._wake.wait(timeout=0.5)
                    if self._stopping and not self._queue:
                        return
                # Batch window: let the tick path pile more records on
                # before paying one fsync for all of them.
                if batch_s > 0:
                    time.sleep(batch_s)
                with self._lock:
                    batch, self._queue = self._queue, []
                t0 = time.monotonic()
                top_seq = self._flushed_seq
                for item in batch:
                    if self._wedged:
                        # Chaos power loss: NOTHING lands after the
                        # tear — not even a checkpoint rewrite, which
                        # would heal the very torn tail the replay
                        # tests exist to exercise.
                        continue
                    if isinstance(item, tuple):
                        f = self._rewrite(f, item[1])
                        continue
                    payload = item.SerializeToString()
                    framed = _frame_record(payload)
                    if _chaos.armed and _chaos.fire("wal.torn_write"):
                        # Power loss mid-append: a PREFIX of this record
                        # reaches disk and nothing after it ever does.
                        f.write(framed[: max(1, len(framed) // 2)])
                        self._wedged = True
                        logger.warning(
                            "chaos: WAL torn mid-append at seq %d; "
                            "writer wedged (simulated power loss)",
                            item.seq,
                        )
                        continue
                    f.write(framed)
                    top_seq = max(top_seq, item.seq)
                if _chaos.armed:
                    stall = _chaos.stall_s("wal.fsync_stall")
                    if stall:
                        time.sleep(stall)
                f.flush()
                os.fsync(f.fileno())
                self._flushed_seq = max(self._flushed_seq, top_seq)
                fsync_ms = (time.monotonic() - t0) * 1000.0
                metrics.wal_fsync_ms.observe(fsync_ms)
                from .slo import slo as _slo

                if _slo.enabled:
                    # wal_fsync_rpo SLO event (core/slo.py; the ring
                    # intake is thread-safe — this is the writer
                    # thread, not the tick path).
                    _slo.observe("wal_fsync", fsync_ms)
        except Exception:
            # The journal can no longer make anything durable: disarm so
            # the hooks stop queueing (unbounded memory otherwise) and
            # the record ledger stops advancing as if durability held.
            self.enabled = False
            with self._lock:
                self._queue.clear()
            logger.exception(
                "WAL writer died; journal DISARMED at seq %d — "
                "durability is now bounded by the snapshot interval",
                self._flushed_seq,
            )
        finally:
            try:
                f.close()
            except OSError:
                pass

    def _rewrite(self, f, cutoff_seq: int):
        """Checkpoint truncation on the writer thread: keep records with
        seq > cutoff, atomically replace the file, reopen for append."""
        f.flush()
        os.fsync(f.fileno())
        records, _torn = read_wal_records(self.path, truncate=False)
        kept = [r for r in records if r.seq > cutoff_seq]
        if len(kept) == len(records):
            return f  # nothing covered: skip the rewrite (idle cycles)
        f.close()
        tmp = f"{self.path}.ckpt.{os.getpid()}"
        with open(tmp, "wb") as out:
            out.write(MAGIC)
            for r in kept:
                out.write(_frame_record(r.SerializeToString()))
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, self.path)
        logger.info(
            "WAL checkpoint: %d/%d records truncated at seq %d",
            len(records) - len(kept), len(records), cutoff_seq,
        )
        return open(self.path, "ab")

    # ---- reporting -------------------------------------------------------

    def report(self) -> dict:
        return {
            "enabled": self.enabled,
            "path": self.path,
            "seq": self._seq,
            "flushed_seq": self._flushed_seq,
            "record_counts": dict(self.record_counts),
            "replay_counts": dict(self.replay_counts),
            "torn_tails": self.torn_tails,
        }


wal = WriteAheadLog()


# ---------------------------------------------------------------------------
# boot replay
# ---------------------------------------------------------------------------


def boot_replay(snapshot_path: str, wal_path: str) -> dict:
    """Crash-consistent boot: snapshot + WAL tail -> live gateway state.

    Runs BEFORE ``wal.start()`` (so replay-side mutations are never
    re-journaled) and inside the GLOBAL tick context when channels are
    already ticking (the crash-soak restart path). Returns a report the
    soak asserts on; also arms the resurrection protocol when the
    federation directory is active."""
    from .snapshot import boot_restore_channels, extras_from, load_snapshot

    t0 = time.monotonic()
    report: dict = {
        "snapshot_channels": 0, "wal_records": 0, "torn": False,
        "applied": {}, "in_flight_resolved": 0, "notices_queued": 0,
        "restored_entities": [], "elapsed_s": 0.0,
    }
    snap = None
    if snapshot_path:
        from .snapshot import sweep_stale_tmp

        sweep_stale_tmp(snapshot_path)
    if snapshot_path and os.path.exists(snapshot_path):
        try:
            snap = load_snapshot(snapshot_path)
        except Exception:
            logger.exception(
                "boot replay: snapshot %s unreadable; replaying WAL over "
                "an empty topology", snapshot_path,
            )
    wal_seq = 0
    if snap is not None:
        report["snapshot_channels"] = boot_restore_channels(snap)
        wal_seq = snap.walSeq
    records, torn = read_wal_records(wal_path) if wal_path else ([], False)
    if torn:
        wal.torn_tails += 1
    report["torn"] = torn
    records = [r for r in records if r.seq > wal_seq]
    report["wal_records"] = len(records)
    max_seq = max([r.seq for r in records], default=wal_seq)

    # ---- fold records last-wins ------------------------------------------
    extras = extras_from(snap) if snap is not None else None
    chan_states: dict[int, object] = {}
    tombstones: set[int] = set()
    in_flight: dict[int, object] = {}  # txn id -> journal record
    if extras is not None:
        for jr in extras["in_flight"]:
            in_flight[jr["txn_id"]] = jr
    batches: dict[int, str] = {}  # batch id -> peer (open batches)
    applied: dict = dict(extras["applied"]) if extras is not None else {}
    staged: dict[str, list] = dict(extras["staged"]) if extras else {}
    directory_state = (
        (extras["directory_version"], extras["overrides"])
        if extras is not None else (0, {})
    )
    banned_ips = set(extras["banned_ips"]) if extras else set()
    banned_pits = set(extras["banned_pits"]) if extras else set()
    geometry_state = (
        extras["geometry"] if extras is not None else (0, frozenset())
    )
    # key -> (key, scope, name, kind, params, spot_dists); last wins.
    queries: dict[int, tuple] = dict(extras["queries"]) if extras else {}
    sim_census = None  # last sim_census record wins
    flips: dict[int, int] = {}
    for r in records:
        k = r.kind
        if k == "channel_state":
            chan_states[r.channelId] = r
            tombstones.discard(r.channelId)
        elif k == "channel_removed":
            tombstones.add(r.channelId)
            chan_states.pop(r.channelId, None)
        elif k == "journal":
            if r.op == "prepared":
                in_flight[r.txnId] = {
                    "txn_id": r.txnId, "entity_id": r.entityId,
                    "src": r.srcChannelId, "dst": r.dstChannelId,
                    "remote": r.remote, "data": r.data, "batch_id": 0,
                    "peer": "",
                }
            else:  # committed / aborted: the transaction resolved
                in_flight.pop(r.txnId, None)
        elif k == "batch":
            batches[r.batchId] = r.peer
            # Stamp member records with their batch identity (the abort
            # notice key). The batch id IS the first record's txn id.
            for eid in r.entityIds:
                for jr in in_flight.values():
                    if jr["entity_id"] == eid and jr["remote"]:
                        jr["batch_id"] = r.batchId
                        jr["peer"] = r.peer
        elif k == "batch_done":
            batches.pop(r.batchId, None)
        elif k == "applied":
            applied[(r.peer, r.batchId)] = (
                r.dstChannelId, list(r.entityIds)
            )
        elif k == "flip":
            for eid in r.entityIds:
                flips[eid] = r.dstChannelId
        elif k == "staged_handle":
            staged[r.pit] = list(r.handleChannelIds)
        elif k == "directory":
            directory_state = (
                r.directoryVersion,
                dict(zip(r.overrideCells, r.overrideGateways)),
            )
        elif k == "blacklist":
            if r.blacklistKind == "ip":
                banned_ips.add(r.blacklistKey)
            else:
                banned_pits.add(r.blacklistKey)
        elif k == "geometry":
            geometry_state = (r.geometryEpoch, frozenset(r.splitCells))
        elif k == "sim_census":
            sim_census = r  # last census wins; applied below
        elif k == "query":
            if r.op == "remove":
                queries.pop(r.queryKey, None)
            else:
                queries[r.queryKey] = (
                    r.queryKey, r.queryScope, r.queryName, r.queryKind,
                    list(r.queryParams), list(r.querySpotDists),
                )
        else:
            logger.warning("unknown WAL record kind %r skipped", k)

    # ---- cell geometry (before channel images: a geometry record was
    # the commit point of a split/merge whose implied mutations may be
    # partially lost — the images must land under the geometry the
    # record committed, and the re-home guard below fixes the rest) ----
    if apply_restored_geometry(*geometry_state):
        wal._count_replayed("geometry")

    # ---- apply channel images --------------------------------------------
    from .channel import create_channel_with_id, get_channel, remove_channel

    for cid, r in sorted(chan_states.items()):
        ch = get_channel(cid)
        if ch is None or ch.is_removing():
            if cid == GLOBAL_CHANNEL_ID:
                continue
            ch = create_channel_with_id(cid, ChannelType(r.channelType),
                                        None)
        ch.metadata = r.metadata
        data_msg = None
        if r.data.type_url:
            try:
                data_msg = unpack_any(r.data)
            except Exception:
                logger.exception(
                    "WAL channel_state for %d undecodable; keeping the "
                    "snapshot-restored data", cid,
                )
                wal._count_replayed("channel_state")
                continue
        merge_options = (
            r.mergeOptions if r.HasField("mergeOptions") else None
        )
        if data_msg is not None:
            if ch.data is None or ch.data.msg is None \
                    or type(ch.data.msg) is not type(data_msg):
                ch.init_data(data_msg, merge_options)
            else:
                ch.data.msg.CopyFrom(data_msg)
        elif ch.data is None:
            ch.init_data(None, merge_options)
        wal._count_replayed("channel_state")
    for cid in tombstones:
        ch = get_channel(cid)
        if ch is not None and not ch.is_removing():
            remove_channel(ch)
        wal._count_replayed("channel_removed")

    # ---- geometry re-home guard ------------------------------------------
    # A crash AFTER the geometry commit point but before the implied
    # moves drained leaves entity rows in cells that are no longer live
    # leaves (a split parent's image, or an orphaned child after a
    # merge). Deterministically re-home each into a live leaf — the
    # flip target if it is one (the move's commit landed), else the
    # leaf containing the stale cell's center — skipping entities whose
    # row already survived elsewhere (zero-dupe), then drop the stale
    # channels. Runs before the ledger re-seed so the ledger only ever
    # sees the final rows.
    rehomed = _rehome_nonleaf_cells(flips)
    if rehomed:
        wal._count_replayed("geometry_rehome", rehomed)
        report["geometry_rehomed"] = rehomed

    # ---- controller re-seed (ledger + device tracking) -------------------
    _reseed_controller(flips)
    if flips:
        wal._count_replayed("flip", len(flips))

    # ---- non-channel durable state ---------------------------------------
    from .ddos import restore_blacklists

    n_ips, n_pits = restore_blacklists(banned_ips, banned_pits)
    if n_ips + n_pits:
        wal._count_replayed("blacklist", n_ips + n_pits)
    from .connection_recovery import stage_recovery_handle

    for pit, cids in sorted(staged.items()):
        live = [c for c in cids if get_channel(c) is not None]
        try:
            stage_recovery_handle(pit, live)
            wal._count_replayed("staged_handle")
        except RuntimeError as e:
            logger.warning("boot replay: re-staging %s failed: %s", pit, e)
    if queries:
        # Standing-query registry (spatial/queryplane.py): sensor rows
        # re-register on the live plane; connection-scoped rows are
        # bound to sockets that did not survive the restart and drop
        # with an exact count.
        from ..spatial.queryplane import restore_registrations

        n_restored, n_dropped = restore_registrations(
            sorted(queries.values()), source="wal replay",
        )
        if n_restored:
            wal._count_replayed("query", n_restored)
        if n_dropped:
            wal._count_replayed("query_dropped", n_dropped)
    if sim_census is not None:
        # Sim plane (channeld_tpu/sim): stash the census for the plane
        # to consume when it activates (controller load order puts the
        # plane after boot replay). Seed + tick + census restore the
        # exact population — the counter-based RNG resumes the
        # identical trajectory.
        from ..sim.plane import restore_census

        n_agents = restore_census(sim_census, source="wal replay")
        if n_agents:
            wal._count_replayed("sim_census", n_agents)
    from ..federation.directory import directory

    version, overrides = directory_state
    if version and directory.active:
        if directory.replace_update(overrides, version) is not None:
            wal._count_replayed("directory")

    # ---- in-flight resolution (source-wins) ------------------------------
    resolved, noticed, restored_ids = _resolve_in_flight(in_flight)
    report["in_flight_resolved"] = resolved
    report["notices_queued"] = noticed
    report["restored_entities"] = restored_ids
    if resolved:
        wal._count_replayed("journal", resolved)

    # ---- applied registry -------------------------------------------------
    if applied:
        from ..federation.plane import MAX_APPLIED_BATCHES, plane

        for key, row in applied.items():
            plane._applied[key] = row
        while len(plane._applied) > MAX_APPLIED_BATCHES:
            plane._applied.popitem(last=False)
        report["applied"] = {f"{k[0]}:{k[1]}": len(v[1])
                             for k, v in applied.items()}
        wal._count_replayed("applied", len(applied))

    # ---- arm the resurrection protocol -----------------------------------
    recovered = bool(chan_states or report["snapshot_channels"])
    if directory.active and recovered:
        from ..federation.control import control

        control.arm_resurrection(len(records),
                                 restored_entities=restored_ids)

    elapsed = time.monotonic() - t0
    report["elapsed_s"] = round(elapsed, 3)
    report["max_seq"] = max_seq
    deadline = global_settings.wal_restart_deadline_s
    log = logger.warning if elapsed > deadline else logger.info
    log(
        "boot replay: %d snapshot channels + %d WAL records (%s) in "
        "%.3fs%s — %d in-flight resolved, %d abort notices queued",
        report["snapshot_channels"], len(records),
        "torn tail truncated" if torn else "clean tail", elapsed,
        f" (OVER the {deadline}s restart deadline)"
        if elapsed > deadline else "",
        resolved, noticed,
    )
    return report


def apply_restored_geometry(epoch: int, splits) -> bool:
    """Apply a snapshot/WAL-restored cell geometry to the live spatial
    controller (adaptive partitioning, doc/partitioning.md). Monotonic:
    a restored epoch at or below the controller's current one is a
    no-op (the restart path replays into an already-current world).
    Returns True when the geometry actually changed."""
    from ..spatial.controller import get_spatial_controller

    ctl = get_spatial_controller()
    tree = getattr(ctl, "tree", None) if ctl is not None else None
    if tree is None:
        if epoch:
            logger.warning(
                "restored geometry epoch %d has no spatial controller "
                "tree to land on; ignored", epoch,
            )
        return False
    if epoch <= tree.epoch and not (epoch == 0 and tree.epoch == 0):
        return False
    if not epoch and not splits:
        return False
    try:
        ctl.apply_geometry(epoch, frozenset(splits))
    except ValueError as e:
        logger.error(
            "restored geometry epoch %d invalid (%s); keeping epoch %d",
            epoch, e, tree.epoch,
        )
        return False
    logger.info(
        "boot replay: cell geometry restored to epoch %d (%d split "
        "cells)", epoch, len(splits),
    )
    return True


def _rehome_nonleaf_cells(flips: dict[int, int]) -> int:
    """Re-home entity rows restored into cells that are not live leaves
    under the final geometry, then remove those stale channels; remap
    ``flips`` rows that target non-leaf cells the same way. Returns the
    number of entities moved."""
    from ..spatial.controller import get_spatial_controller
    from .channel import (
        all_channels, create_channel_with_id, get_channel, remove_channel,
    )

    ctl = get_spatial_controller()
    tree = getattr(ctl, "tree", None) if ctl is not None else None
    if tree is None:
        return 0
    st = global_settings
    lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start

    def _live_leaf(cell: int) -> bool:
        try:
            return tree.exists(cell) and tree.is_leaf(cell)
        except ValueError:
            return False

    def _center_leaf(cell: int):
        try:
            cx, cz = tree.center(cell)
        except ValueError:
            return None
        return tree.leaf_at(cx, cz)

    stale = sorted(
        (cid, ch) for cid, ch in all_channels().items()
        if lo <= cid < hi and not ch.is_removing()
        and not _live_leaf(cid)
    )
    moved = 0
    for cid, ch in stale:
        ents = dict(getattr(ch.get_data_message(), "entities", None) or {})
        for eid in sorted(ents):
            # Zero-dupe: if a live row for this entity survived in any
            # other cell image, that row wins and this one just drops
            # with the stale channel.
            if any(
                eid in (getattr(c2.get_data_message(), "entities", None)
                        or {})
                for cid2, c2 in all_channels().items()
                if lo <= cid2 < hi and cid2 != cid
                and not c2.is_removing()
            ):
                continue
            tgt = flips.get(eid)
            if tgt is None or not _live_leaf(tgt):
                tgt = _center_leaf(cid)
            if tgt is None:
                continue
            tch = get_channel(tgt)
            if tch is None or tch.is_removing():
                tch = create_channel_with_id(
                    tgt, ChannelType.SPATIAL, ch.get_owner()
                )
                data_msg = ch.get_data_message()
                tch.init_data(
                    type(data_msg)() if data_msg is not None else None,
                    getattr(ch.data, "merge_options", None),
                )
            adder = getattr(tch.get_data_message(), "add_entity", None)
            data = ents[eid]
            if adder is not None and data is not None:
                adder(eid, data)
                flips[eid] = tgt
                moved += 1
        logger.info(
            "boot replay: cell %d is not a live leaf under geometry "
            "epoch %d; %d resident entities re-homed, channel dropped",
            cid, tree.epoch, len(ents),
        )
        remove_channel(ch)
    # Flips that point at non-leaf cells (the move committed, then the
    # geometry moved on) re-map to the leaf containing the dead cell's
    # center so the ledger overlay never lands on a cell that isn't
    # there.
    for eid, cell in list(flips.items()):
        if not _live_leaf(cell):
            tgt = _center_leaf(cell)
            if tgt is None:
                del flips[eid]
            else:
                flips[eid] = tgt
    return moved


def _reseed_controller(flips: dict[int, int]) -> None:
    """Rebuild the placement ledger + device tracking from the restored
    cell rows (the same discipline as the failover re-host seed), then
    overlay the explicit flip records — mid-crossing entities
    re-baseline to where their data is bound, not where a stale row
    says."""
    from ..spatial.controller import get_spatial_controller
    from .channel import all_channels, get_channel

    ctl = get_spatial_controller()
    if ctl is None:
        return
    st = global_settings
    lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start
    tracker = getattr(ctl, "track_entity", None)
    moved_hook = getattr(ctl, "_note_entity_data_moved", None)
    center_of = getattr(ctl, "_cell_center", None)
    tree = getattr(ctl, "tree", None)
    if tree is not None:
        # Geometry-aware: a child cell's id is NOT a base-grid index,
        # so derive the seed position from the tree's world-space
        # center instead of ``cid - lo`` arithmetic.
        from ..spatial.controller import SpatialInfo

        def center_of(idx, _tree=tree, _lo=lo):  # noqa: F811
            x, z = _tree.center(_lo + idx)
            return SpatialInfo(x, 0.0, z)
    for cid, ch in list(all_channels().items()):
        if not (lo <= cid < hi) or ch.is_removing():
            continue
        ents = getattr(ch.get_data_message(), "entities", None)
        if not ents:
            continue
        owner = ch.get_owner()
        for eid in list(ents):
            ech = get_channel(eid)
            if ech is not None and not ech.is_removing():
                ech.spatial_notifier = ctl
                if not ech.has_owner() and owner is not None:
                    ech.set_owner(owner)
            if tracker is not None and center_of is not None:
                tracker(eid, center_of(cid - lo))
            if moved_hook is not None:
                moved_hook([eid], cid)
    if moved_hook is not None:
        for eid, cell in flips.items():
            if get_channel(eid) is not None:
                moved_hook([eid], cell)


def _resolve_in_flight(in_flight: dict) -> tuple[int, int, list[int]]:
    """Deterministic crash resolution of replayed in-flight handover
    transactions — the failover discipline applied at boot: the entity
    belongs to the SRC cell unless a replayed cell image already holds
    a live row for it somewhere (the dst add landed and its commit
    record was simply lost to the fsync window). Remote batches
    additionally queue source-wins abort notices at their destination
    (the peer may have applied the batch; its copy purges on
    reconnect)."""
    from .channel import all_channels, get_channel

    st = global_settings
    lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start

    def _in_some_cell(eid: int) -> bool:
        for cid, ch in all_channels().items():
            if lo <= cid < hi and not ch.is_removing():
                ents = getattr(ch.get_data_message(), "entities", None)
                if ents is not None and eid in ents:
                    return True
        return False

    resolved = 0
    restored_ids: list[int] = []
    notices: dict[str, set] = {}
    for jr in in_flight.values():
        resolved += 1
        eid = jr["entity_id"]
        if jr["remote"] and jr["peer"]:
            # The destination may hold an applied copy whose ack never
            # reached us: source-wins, purge it there.
            notices.setdefault(jr["peer"], set()).add(
                jr["batch_id"] or jr["txn_id"]
            )
        if _in_some_cell(eid):
            continue  # the add landed; the row is the live copy
        src = get_channel(jr["src"])
        if src is None or src.is_removing():
            continue
        data = None
        any_msg = jr.get("data")
        if any_msg is not None and getattr(any_msg, "type_url", ""):
            try:
                data = unpack_any(any_msg)
            except Exception:
                logger.exception(
                    "in-flight entity %d data undecodable at replay", eid
                )
        if data is None:
            ech = get_channel(eid)
            data = ech.get_data_message() if ech is not None else None
        if data is None:
            continue

        def _readd(c, e=eid, d=data):
            adder = getattr(c.get_data_message(), "add_entity", None)
            if adder is not None:
                adder(e, d)

        src.execute(_readd)
        restored_ids.append(eid)
        logger.warning(
            "boot replay: in-flight handover txn %d resolved — entity %d "
            "restored to cell %d (dst %d never committed)",
            jr["txn_id"], eid, jr["src"], jr["dst"],
        )
    noticed = 0
    if notices:
        from ..federation.plane import plane

        now = time.monotonic()
        for peer, batch_ids in notices.items():
            slot = plane._abort_notices.setdefault(peer, {})
            for bid in batch_ids:
                slot[("", bid)] = now
                noticed += 1
    return resolved, noticed, restored_ids


def reset_wal() -> None:
    """Test hook."""
    wal.stop(flush=False)
    wal.reset()
