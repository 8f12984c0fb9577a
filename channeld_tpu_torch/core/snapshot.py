"""Durable gateway snapshots: channel topology + authoritative data.

Beyond-reference capability (the reference has none; persistence is on
its roadmap — SURVEY §5). A snapshot captures every channel's id, type,
metadata, data message and merge options — plus, since the WAL plane
landed (doc/persistence.md), everything else the write-ahead journal
covers, so a snapshot write can CHECKPOINT the journal (truncate
records it covers) without losing durable state: anti-DDoS blacklists,
staged recovery handles, the shard directory's override version, the
in-flight handover journal, and the applied-batch registry. Restoring
at boot recreates all of it. Connection-bound state (subscriptions,
owners) is intentionally excluded — connections don't survive a
restart; the recovery subsystem (connection_recovery.py) restores
those when the servers reconnect.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
from typing import Optional

from ..protocol import snapshot_pb2
from ..utils.anyutil import pack_any, unpack_any
from ..utils.logger import get_logger
from .types import ChannelType, GLOBAL_CHANNEL_ID

logger = get_logger("snapshot")


def pack_channel_state(ch):
    """One channel's authoritative data as a packed Any, or None when the
    channel holds no data. The single pack path shared by snapshots, the
    failover plane's cell-bootstrap stream (core/failover.py), AND the
    WAL's per-tick channel_state records (core/wal.py) — what a restored
    gateway would serve, what a re-hosted cell's new owner receives, and
    what a crash replay reconstructs are byte-identical by construction."""
    if ch.data is None or ch.data.msg is None:
        return None
    return pack_any(ch.data.msg)


def take_snapshot() -> snapshot_pb2.GatewaySnapshot:
    from .channel import all_channels

    snap = snapshot_pb2.GatewaySnapshot(takenAt=int(time.time()))
    for ch in all_channels().values():
        if ch.is_removing():
            continue
        entry = snap.channels.add(
            channelId=ch.id, channelType=ch.channel_type, metadata=ch.metadata
        )
        packed = pack_channel_state(ch)
        if packed is not None:
            entry.data.CopyFrom(packed)
            if ch.data.merge_options is not None:
                entry.mergeOptions.CopyFrom(ch.data.merge_options)
    _pack_extras(snap)
    from .wal import wal

    if wal.enabled:
        # Records at or below this are covered by THIS snapshot: replay
        # skips them and the post-write checkpoint truncates them.
        snap.walSeq = wal.current_seq()
    return snap


def _pack_extras(snap: snapshot_pb2.GatewaySnapshot) -> None:
    """The non-channel durable state (everything the WAL also journals,
    so checkpoint truncation never loses it — doc/persistence.md)."""
    from .connection_recovery import staged_handle_snapshot
    from .ddos import blacklist_snapshot
    from .failover import journal

    ips, pits = blacklist_snapshot()
    snap.bannedIps.extend(ips)
    snap.bannedPits.extend(pits)
    for pit, cids in staged_handle_snapshot():
        snap.stagedHandles.add(pit=pit, channelIds=cids)
    from ..federation.directory import directory

    if directory.active:
        snap.directoryVersion = directory.override_version
        for cid, gw in sorted(directory.overrides().items()):
            snap.overrideCells.append(cid)
            snap.overrideGateways.append(gw)
    # Cell geometry (adaptive partitioning): checkpoint truncation drops
    # the WAL's geometry records, so the snapshot must carry them.
    from ..spatial.controller import get_spatial_controller

    _ctl = get_spatial_controller()
    if _ctl is not None and getattr(_ctl, "tree", None) is not None:
        snap.geometryEpoch = _ctl.tree.epoch
        snap.splitCells.extend(sorted(_ctl.tree.splits))
    # Standing-query registry (spatial/queryplane.py): checkpoint
    # truncation drops the WAL's query records, so the snapshot must
    # carry the registry or a post-checkpoint restart would silently
    # lose every sensor.
    _plane = getattr(_ctl, "queryplane", None) if _ctl is not None else None
    if _plane is not None:
        for key, scope, name, kind, params, spot_dists in _plane.snapshot_rows():
            snap.standingQueries.add(
                key=key, scope=scope, name=name, kind=kind,
                params=params, spotDists=spot_dists,
            )
    # In-flight handover transactions (an entity mid-crossing is in
    # NEITHER cell's data — same blindness the epoch replica closes).
    # Remote records carry their trunk batch identity for the
    # post-restart source-wins abort notice.
    batch_of: dict = {}
    from ..federation.plane import plane

    if plane.active:
        for batch in plane._pending.values():
            for rec in batch.records:
                batch_of[(rec.entity_id, rec.txn_id)] = (
                    batch.batch_id, batch.peer
                )
        for (initiator, batch_id), (dst_cid, eids) in plane._applied.items():
            snap.applied.add(initiator=initiator, batchId=batch_id,
                             dstChannelId=dst_cid, entityIds=eids)
    for rec in journal.in_flight_records():
        e = snap.inFlight.add(
            txnId=rec.txn_id, entityId=rec.entity_id,
            srcChannelId=rec.src_channel_id,
            dstChannelId=rec.dst_channel_id, remote=rec.remote,
        )
        if rec.data is not None:
            e.data.CopyFrom(pack_any(rec.data))
        bid_peer = batch_of.get((rec.entity_id, rec.txn_id))
        if bid_peer is not None:
            e.batchId, e.peer = bid_peer


_tmp_seq = itertools.count()


def write_snapshot(snap: snapshot_pb2.GatewaySnapshot, path: str) -> str:
    """Durable write: tmp file, fsync, then atomic rename — a crash at
    any point leaves either the old snapshot or the new one, never a
    torn file. Shared by the one-shot save, the periodic loop, the
    shutdown drain, and the device guard's fatal/recovery snapshots.
    The tmp name is writer-unique: the guard legitimately schedules two
    off-thread writes back-to-back (fatal then recovered), and a shared
    ``.tmp`` would let one writer rename the other's file out from
    under it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_seq)}"
    try:
        with open(tmp, "wb") as f:
            f.write(snap.SerializeToString())
            f.flush()
            os.fsync(f.fileno())  # data durable before the rename lands
        os.replace(tmp, path)  # atomic
    finally:
        try:
            os.remove(tmp)  # only survives when the replace never ran
        except OSError:
            pass
    return path


def save_snapshot(path: str) -> str:
    snap = take_snapshot()
    write_snapshot(snap, path)
    from .wal import wal

    wal.checkpoint(snap.walSeq)
    logger.info("saved snapshot of %d channels to %s", len(snap.channels), path)
    return path


def load_snapshot(path: str) -> snapshot_pb2.GatewaySnapshot:
    with open(path, "rb") as f:
        snap = snapshot_pb2.GatewaySnapshot()
        snap.ParseFromString(f.read())
    return snap


def boot_restore_channels(snap: snapshot_pb2.GatewaySnapshot) -> int:
    """Recreate (or refresh in place) channels from a parsed snapshot;
    returns how many. Must run after init_channels (the GLOBAL channel
    exists, ownerless). Channels that already exist — e.g. spatial cells
    a reconnected server re-created before the replay ran — keep their
    owner and get their data replaced, not a fresh Channel object."""
    from .channel import create_channel_with_id, get_channel

    restored = 0
    for entry in snap.channels:
        ch = get_channel(entry.channelId)
        if ch is None:
            if entry.channelId == GLOBAL_CHANNEL_ID:
                continue  # GLOBAL always exists post-init
            ch = create_channel_with_id(
                entry.channelId, ChannelType(entry.channelType), None
            )
        ch.metadata = entry.metadata
        if entry.HasField("data"):
            try:
                data_msg = unpack_any(entry.data)
            except Exception:
                logger.exception(
                    "failed to restore data for channel %d", entry.channelId
                )
                continue
            merge_options = entry.mergeOptions if entry.HasField("mergeOptions") else None
            if ch.data is not None and ch.data.msg is not None \
                    and type(ch.data.msg) is type(data_msg):
                ch.data.msg.CopyFrom(data_msg)
            else:
                ch.init_data(data_msg, merge_options)
        restored += 1
    logger.info("restored %d channels from snapshot (taken %s)", restored,
                time.strftime("%F %T", time.localtime(snap.takenAt)))
    return restored


def extras_from(snap: snapshot_pb2.GatewaySnapshot) -> dict:
    """The snapshot's non-channel durable state in the shape the boot
    replay folds WAL records into (core/wal.py boot_replay)."""
    return {
        "banned_ips": list(snap.bannedIps),
        "banned_pits": list(snap.bannedPits),
        "staged": {h.pit: list(h.channelIds) for h in snap.stagedHandles},
        "directory_version": snap.directoryVersion,
        "overrides": dict(zip(snap.overrideCells, snap.overrideGateways)),
        "in_flight": [
            {
                "txn_id": e.txnId, "entity_id": e.entityId,
                "src": e.srcChannelId, "dst": e.dstChannelId,
                "remote": e.remote, "data": e.data,
                "batch_id": e.batchId, "peer": e.peer,
            }
            for e in snap.inFlight
        ],
        "applied": {
            (a.initiator, a.batchId): (a.dstChannelId, list(a.entityIds))
            for a in snap.applied
        },
        "geometry": (snap.geometryEpoch, frozenset(snap.splitCells)),
        "queries": {
            q.key: (q.key, q.scope, q.name, q.kind,
                    list(q.params), list(q.spotDists))
            for q in snap.standingQueries
        },
    }


def restore_snapshot(path: str) -> int:
    """Recreate channels (and the non-channel durable state) from a
    snapshot file; returns how many channels. Must run after
    init_channels. The snapshot-only boot path — a WAL boot goes
    through core/wal.py boot_replay instead, which merges these extras
    with the journal tail before applying them."""
    snap = load_snapshot(path)
    restored = boot_restore_channels(snap)
    extras = extras_from(snap)
    from .wal import apply_restored_geometry

    apply_restored_geometry(*extras["geometry"])
    from .ddos import restore_blacklists

    restore_blacklists(extras["banned_ips"], extras["banned_pits"])
    from .channel import get_channel
    from .connection_recovery import stage_recovery_handle

    for pit, cids in sorted(extras["staged"].items()):
        live = [c for c in cids if get_channel(c) is not None]
        try:
            stage_recovery_handle(pit, live)
        except RuntimeError as e:
            logger.warning("snapshot restore: re-staging %s failed: %s",
                           pit, e)
    from ..federation.directory import directory

    if extras["directory_version"] and directory.active:
        directory.replace_update(extras["overrides"],
                                 extras["directory_version"])
    if extras["in_flight"]:
        from .wal import _resolve_in_flight

        _resolve_in_flight({jr["txn_id"]: jr
                            for jr in extras["in_flight"]})
    if extras["applied"]:
        from ..federation.plane import MAX_APPLIED_BATCHES, plane

        for key, row in extras["applied"].items():
            plane._applied.setdefault(key, row)
        while len(plane._applied) > MAX_APPLIED_BATCHES:
            plane._applied.popitem(last=False)
    if extras["queries"]:
        from ..spatial.queryplane import restore_registrations

        restore_registrations(sorted(extras["queries"].values()),
                              source="snapshot restore")
    return restored


def sweep_stale_tmp(path: str) -> int:
    """Remove ``.tmp`` residue a kill -9 left next to the snapshot (a
    crash between the tmp write and the rename): the residue is never
    read — boot restores from ``path`` only — but a crash-looping
    gateway would otherwise accumulate one orphan per loop."""
    base = os.path.basename(path)
    parent = os.path.dirname(path) or "."
    swept = 0
    try:
        names = os.listdir(parent)
    except OSError:
        return 0
    for name in names:
        if name.startswith(base + ".tmp."):
            try:
                os.remove(os.path.join(parent, name))
                swept += 1
            except OSError:
                pass
    if swept:
        logger.info("swept %d stale snapshot .tmp files next to %s",
                    swept, path)
    return swept


def boot_restore(path: str) -> int:
    """The boot-time restore step behind the ``-snapshot`` flag: restore
    when a snapshot exists, start fresh when it doesn't, and never let a
    corrupt file block boot. Returns the number of channels restored
    (0 = fresh start). Must run after init_channels."""
    sweep_stale_tmp(path)
    if not os.path.exists(path):
        return 0
    try:
        return restore_snapshot(path)
    except Exception:
        logger.exception(
            "failed to restore snapshot %s; starting with an empty "
            "topology", path,
        )
        return 0


def snapshot_digest(snap: snapshot_pb2.GatewaySnapshot) -> str:
    """Content hash of the packed state, excluding the fields that
    change on every cycle (takenAt, walSeq) — what the skip-unchanged
    periodic writer compares."""
    taken, seq = snap.takenAt, snap.walSeq
    snap.takenAt = 0
    snap.walSeq = 0
    try:
        return hashlib.sha256(snap.SerializeToString()).hexdigest()
    finally:
        snap.takenAt = taken
        snap.walSeq = seq


async def snapshot_loop(path: str, interval_s: float = 30.0) -> None:
    """Periodic snapshot writer (scheduled by run_server when the
    ``-snapshot`` flag names a path; cadence from ``-snapshot-interval``).
    Skip-unchanged: the packed state is hashed and an idle gateway pays
    one pack + hash per interval, zero disk traffic
    (``snapshot_writes_total{result}`` / ``snapshot_bytes`` /
    ``snapshot_ms``). Every cycle — written or skipped — checkpoints
    the WAL at the sequence the (current or still-valid previous)
    snapshot covers."""
    import asyncio

    from . import metrics
    from .wal import wal

    last_digest: Optional[str] = None
    while True:
        await asyncio.sleep(max(interval_s, 1.0))
        try:
            # take_snapshot touches channel state and must run on the loop;
            # the serialization + fsync'd write offloads to a thread so
            # ticks/flushes never stall behind disk IO.
            t0 = time.monotonic()
            snap = take_snapshot()
            digest = snapshot_digest(snap)
            if digest == last_digest:
                # Identical packed state: the previous file already
                # covers everything up to walSeq (the records since
                # produced no net durable change), so the checkpoint
                # still advances.
                metrics.snapshot_writes.labels(result="skipped").inc()
                wal.checkpoint(snap.walSeq)
                metrics.snapshot_ms.observe(
                    (time.monotonic() - t0) * 1000.0
                )
                continue
            blob_len = snap.ByteSize()
            await asyncio.to_thread(write_snapshot, snap, path)
            last_digest = digest
            metrics.snapshot_writes.labels(result="written").inc()
            metrics.snapshot_bytes.set(blob_len)
            metrics.snapshot_ms.observe((time.monotonic() - t0) * 1000.0)
            wal.checkpoint(snap.walSeq)
            logger.info(
                "saved snapshot of %d channels to %s", len(snap.channels), path
            )
        except Exception:
            metrics.snapshot_writes.labels(result="failed").inc()
            logger.exception("periodic snapshot failed")
