"""Device-native standing-query plane (doc/query_engine.md).

Every standing interest a gateway serves — entity-follow AOI, client
``UpdateSpatialInterestMessage`` queries, and the server-facing sensor
API — becomes ONE row in the engine's device query table. Per tick the
engine evaluates every row's cell-interest mask in the existing batched
AOI pass, diffs against the committed baseline ON DEVICE
(ops/spatial_ops.diff_query_masks) and compacts the delta to changed
``(query_row, cell, dist)`` rows; the host consumes them in ONE
transfer and drives the existing sub/unsub machinery through
``apply_interest_diff`` — host work is O(changed rows), never
O(standing queries).

The plane keeps a host MIRROR per engine row ({micro_cell: dist},
reconstructed purely from changed rows) so an apply pass always hands
``apply_interest_diff`` the query's FULL desired set — the diff against
``conn.spatial_subscriptions`` then yields exactly the sub/unsub delta,
and a full-resync (engine query epoch moved: device-guard rebuild or
geometry epoch threw the diff baseline away) is just "clear mirrors,
mark everything pending" with the device re-emitting every row against
its empty baseline.

Registrations journal to the WAL (``query`` records) and ride the
snapshot + the federation epoch replica next to staged handles: sensor
rows survive kill -9 and shard adoption; connection-scoped rows
(follow/client) are bound to sockets that did not survive, so replay
drops them with an exact count.

Double-entry discipline: every metric this plane increments has a
python-side ledger entry (``QueryPlane.ledgers``) that must match —
soak/bench invariant gates compare the two.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..core import metrics
from ..core.settings import global_settings
from ..ops.spatial_ops import AOI_NONE, AOI_SPHERE, AOI_SPOTS
from ..utils.logger import get_logger

logger = get_logger("spatial.queryplane")

# Sensor keys live far above any real connection id (conn ids are dense
# small ints): the engine query table is keyed by "conn id", and sensors
# are server-side rows with no connection.
SENSOR_KEY_BASE = 1 << 30

_SCOPES = ("follow", "client", "sensor")


def pack_params(center, extent, direction, angle, spots=None) -> list:
    """Flatten one registration's geometry for WAL/snapshot/replica
    transport: [cx, cz, ex, ez, dx, dz, angle, spot0x, spot0z, ...]."""
    params = [
        float(center[0]), float(center[1]),
        float(extent[0]), float(extent[1]),
        float(direction[0]), float(direction[1]),
        float(angle),
    ]
    for s in spots or []:
        params.extend((float(s[0]), float(s[1])))
    return params


def unpack_params(params) -> tuple:
    """Inverse of pack_params: (center, extent, direction, angle, spots)."""
    p = list(params) + [0.0] * max(0, 7 - len(params))
    spots = [(p[i], p[i + 1]) for i in range(7, len(p) - 1, 2)]
    return (p[0], p[1]), (p[2], p[3]), (p[4], p[5]), p[6], spots


class QueryPlane:
    """Registry + changed-rows consumer over one SpatialEngine."""

    def __init__(self, controller, engine):
        self.controller = controller
        self.engine = engine
        engine.query_rows_max = global_settings.queryplane_rows_max
        engine.track_query_changes = True
        # key -> registration entry. Keys are connection ids for
        # follow/client scopes (one engine row per connection — a plain
        # query replaces a follow and vice versa, the reference's
        # semantics) and synthetic ids >= SENSOR_KEY_BASE for sensors.
        self._entries: dict[int, dict] = {}
        # engine row -> key (the changed rows cite engine rows).
        self._key_of_row: dict[int, int] = {}
        # engine row -> {micro_cell: dist}: the host mirror of the
        # device's committed interest, rebuilt purely from changed rows.
        self._mirror: dict[int, dict[int, int]] = {}
        # Keys whose mirror changed since their last apply pass.
        self._pending: set[int] = set()
        self._epoch_seen = engine.query_epoch
        self._sensor_next = SENSOR_KEY_BASE
        # Double-entry ledgers; each must equal its metric exactly.
        self.ledgers = {
            "rows_changed": 0,    # == query_rows_changed_total
            "transfers": 0,       # == query_plane_transfers_total
            "full_resyncs": 0,    # == query_full_resyncs_total
            "applies": 0,         # apply passes run (no metric; bench)
            "reaped": 0,          # rows reaped on connection churn
            "replay_dropped": 0,  # conn-scoped rows dropped at replay
        }

    # ---- registry --------------------------------------------------------

    def count(self) -> int:
        return len(self._entries)

    def _scope_gauges(self) -> None:
        counts = dict.fromkeys(_SCOPES, 0)
        for e in self._entries.values():
            counts[e["scope"]] += 1
        for scope, n in counts.items():
            metrics.standing_queries.labels(scope=scope).set(n)

    def _install(self, key: int, entry: dict, journal: bool) -> None:
        row = self.engine.query_row_of_conn(key)
        if row is None:  # engine rejected the row (shouldn't happen here)
            return
        old_key = self._key_of_row.get(row)
        if old_key is not None and old_key != key:
            # Freed row reused: the engine zeroed its diff baseline
            # (_q_prev_reset_rows), so the mirror restarts empty too —
            # the next tick full-emits the new query's cells.
            self._mirror.pop(row, None)
        self._key_of_row[row] = key
        entry["row"] = row
        self._entries[key] = entry
        self._pending.add(key)
        self._scope_gauges()
        if journal:
            self._journal(key, entry, op="set")

    def _journal(self, key: int, entry: dict, op: str) -> None:
        from ..core.wal import wal

        wal.log_query(
            op=op, key=key, scope=entry["scope"],
            name=entry.get("name", ""), kind=entry.get("kind", AOI_NONE),
            params=pack_params(
                entry.get("center", (0.0, 0.0)),
                entry.get("extent", (0.0, 0.0)),
                entry.get("direction", (1.0, 0.0)),
                entry.get("angle", 0.0),
                entry.get("spots"),
            ),
            spot_dists=entry.get("dists") or [],
        )

    def bind_follow(self, conn, entity_id: int, kind: int, center, extent,
                    direction, angle) -> None:
        """Adopt a follow row the controller just wrote into the engine
        (register_follow_interest stays the single writer for follows —
        it owns re-centering and the shed policy)."""
        self._install(conn.id, {
            "scope": "follow", "conn": conn, "entity": entity_id,
            "kind": kind, "center": tuple(center), "extent": tuple(extent),
            "direction": tuple(direction), "angle": float(angle),
        }, journal=True)

    def register_client(self, conn, kind: int, center, extent=(0.0, 0.0),
                        direction=(1.0, 0.0), angle: float = 0.0) -> bool:
        """A client's geometric standing query: the host path already
        applied the initial interest synchronously (handler semantics
        unchanged); this row keeps it live — geometry epochs, rebuilds
        and damping-distance drift re-apply with no client round trip."""
        try:
            self.engine.set_query(conn.id, kind, tuple(center),
                                  tuple(extent), tuple(direction),
                                  float(angle))
        except RuntimeError:
            self.controller._shed("query", f"conn {conn.id} client query")
            return False
        self._install(conn.id, {
            "scope": "client", "conn": conn, "kind": kind,
            "center": tuple(center), "extent": tuple(extent),
            "direction": tuple(direction), "angle": float(angle),
        }, journal=True)
        return True

    def register_client_spots(self, conn, spots, dists) -> bool:
        try:
            self.engine.set_spots_query(conn.id, list(spots),
                                        list(dists) if dists else None)
        except RuntimeError:
            self.controller._shed("query", f"conn {conn.id} spots query")
            return False
        self._install(conn.id, {
            "scope": "client", "conn": conn, "kind": AOI_SPOTS,
            "spots": [tuple(s) for s in spots],
            "dists": list(dists) if dists else None,
        }, journal=True)
        return True

    def register_sensor(
        self,
        name: str,
        kind: int = AOI_SPHERE,
        center=(0.0, 0.0),
        extent=(0.0, 0.0),
        direction=(1.0, 0.0),
        angle: float = 0.0,
        spots=None,
        dists=None,
        callback: Optional[Callable[[int, dict], None]] = None,
        key: Optional[int] = None,
        journal: bool = True,
    ) -> Optional[int]:
        """Server-facing standing sensor: a named query row with no
        connection. Its interest set ({leaf_channel: dist}) refreshes
        from changed rows like any other query; consumers either poll
        ``sensor_cells(key)`` or get ``callback(key, cells)`` on every
        change. Returns the sensor key, or None when the table is full
        (shed, never raise — same policy as follows)."""
        if key is None:
            key = self._sensor_next
            self._sensor_next += 1
        else:
            self._sensor_next = max(self._sensor_next, key + 1)
        try:
            if spots is not None:
                self.engine.set_spots_query(key, list(spots),
                                            list(dists) if dists else None)
            else:
                self.engine.set_query(key, kind, tuple(center),
                                      tuple(extent), tuple(direction),
                                      float(angle))
        except RuntimeError:
            self.controller._shed("query", f"sensor {name!r}")
            return None
        entry = {
            "scope": "sensor", "conn": None, "name": name, "kind": kind,
            "center": tuple(center), "extent": tuple(extent),
            "direction": tuple(direction), "angle": float(angle),
            "callback": callback, "cells": {},
        }
        if spots is not None:
            entry["kind"] = AOI_SPOTS
            entry["spots"] = [tuple(s) for s in spots]
            entry["dists"] = list(dists) if dists else None
        self._install(key, entry, journal=journal)
        return key

    def deregister(self, key: int, reaped: bool = False) -> bool:
        """Drop a standing query: free the engine row (its diff baseline
        is zeroed, so the row emits nothing for its next owner) and
        synchronously unsubscribe a still-open connection — the mirror
        dies with the row, so there is no async removal stream to wait
        for."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return False
        row = self.engine.query_row_of_conn(key)
        self.engine.remove_query(key)
        if row is not None:
            self._mirror.pop(row, None)
            if self._key_of_row.get(row) == key:
                del self._key_of_row[row]
        self._pending.discard(key)
        conn = entry.get("conn")
        if conn is not None and not conn.is_closing():
            from .messages import apply_interest_diff

            apply_interest_diff(conn, {})
        if reaped:
            self.ledgers["reaped"] += 1
        self._scope_gauges()
        self._journal(key, entry, op="remove")
        return True

    def reap_closed(self) -> None:
        """Connection-churn discipline (bounded registry): a closed
        connection's standing rows must not stay in the device pass
        forever. Follow rows are reaped by the controller's follower
        walk; this covers client-scope rows."""
        for key, entry in list(self._entries.items()):
            conn = entry.get("conn")
            if conn is not None and conn.is_closing():
                self.deregister(key, reaped=True)

    def sensor_cells(self, key: int) -> dict[int, int]:
        """Last-applied {leaf_channel_id: grid_distance} for a sensor."""
        entry = self._entries.get(key)
        return dict(entry.get("cells", {})) if entry else {}

    # ---- the per-tick pass ----------------------------------------------

    def pump(self, result: dict, apply: bool = True) -> None:
        """Consume this tick's changed rows and (unless deferred by the
        overload ladder) run the apply pass. Consume ALWAYS drains: the
        device committed its new baseline when the tick ran, so a blob
        left unconsumed is a permanently lost delta."""
        t0 = time.monotonic()
        self._consume(result)
        if apply:
            self._apply_pending()
        metrics.query_pass_ms.observe((time.monotonic() - t0) * 1000.0)

    def _consume(self, result: dict) -> None:
        epoch = result.get("query_epoch", self.engine.query_epoch)
        if epoch != self._epoch_seen:
            # The engine threw its diff baseline away (device-guard
            # rebuild / geometry epoch): the delta stream no longer
            # connects to our mirrors. Restart them empty — this very
            # result's rows are the device's full re-emission against
            # its fresh baseline — and re-apply every registration
            # (after a geometry epoch the micro->leaf collapse changed
            # even for cells whose micro mask did not).
            self._epoch_seen = epoch
            self._mirror.clear()
            self._pending.update(self._entries.keys())
            self.ledgers["full_resyncs"] += 1
            metrics.query_full_resyncs.inc()
        count, rows = self.engine.query_changed_rows(result)
        self.ledgers["transfers"] += 1
        metrics.query_plane_transfers.inc()
        consumed = 0
        for q, c, d in rows[: min(count, len(rows))].tolist():
            if q < 0:
                continue  # compaction discard lane
            mirror = self._mirror.setdefault(q, {})
            if d < 0:
                mirror.pop(c, None)
            else:
                mirror[c] = d
            consumed += 1
            key = self._key_of_row.get(q)
            if key is not None:
                self._pending.add(key)
        if consumed:
            self.ledgers["rows_changed"] += consumed
            metrics.query_rows_changed.inc(consumed)

    def _apply_pending(self) -> None:
        from .messages import apply_interest_diff

        while self._pending:
            key = self._pending.pop()
            entry = self._entries.get(key)
            if entry is None:
                continue
            row = self.engine.query_row_of_conn(key)
            desired = self._mirror.get(row, {}) if row is not None else {}
            wanted = self.controller.collapse_micro_cells(desired)
            self.ledgers["applies"] += 1
            if entry["scope"] == "sensor":
                entry["cells"] = wanted
                cb = entry.get("callback")
                if cb is not None:
                    try:
                        cb(key, dict(wanted))
                    except Exception:
                        logger.exception(
                            "sensor %r callback failed", entry.get("name")
                        )
            else:
                conn = entry.get("conn")
                if conn is None or conn.is_closing():
                    continue  # reap will free the row
                apply_interest_diff(conn, wanted)

    # ---- persistence / replication --------------------------------------

    def snapshot_rows(self) -> list[tuple]:
        """Every registration as (key, scope, name, kind, params,
        spot_dists) — the WAL/snapshot/replica transport shape."""
        out = []
        for key, e in self._entries.items():
            out.append((
                key, e["scope"], e.get("name", ""),
                int(e.get("kind", AOI_NONE)),
                pack_params(
                    e.get("center", (0.0, 0.0)), e.get("extent", (0.0, 0.0)),
                    e.get("direction", (1.0, 0.0)), e.get("angle", 0.0),
                    e.get("spots"),
                ),
                list(e.get("dists") or []),
            ))
        return out

    def restore_rows(self, rows, source: str) -> tuple[int, int]:
        """Re-register persisted/adopted rows (WAL replay, snapshot
        restore, shard adoption). Sensor rows re-register (no callback —
        consumers poll ``sensor_cells`` or re-attach one); follow/client
        rows are bound to connections that did not survive the restart,
        so they drop with an exact count. Returns (restored, dropped)."""
        restored = dropped = 0
        for key, scope, name, kind, params, spot_dists in rows:
            if scope != "sensor":
                dropped += 1
                continue
            center, extent, direction, angle, spots = unpack_params(params)
            got = self.register_sensor(
                name=name, kind=int(kind), center=center, extent=extent,
                direction=direction, angle=angle,
                spots=spots if int(kind) == AOI_SPOTS else None,
                dists=list(spot_dists) if spot_dists else None,
                key=int(key), journal=False,
            )
            if got is not None:
                restored += 1
        self.ledgers["replay_dropped"] += dropped
        if restored or dropped:
            logger.info(
                "query plane %s: %d sensor registrations restored, "
                "%d connection-scoped rows dropped", source, restored,
                dropped,
            )
        return restored, dropped


def restore_registrations(rows, source: str = "wal") -> tuple[int, int]:
    """Module-level restore hook for boot replay: find the live TPU
    controller's plane and hand it the persisted rows. (0, 0) when the
    gateway runs the host backend or the plane is disabled — the rows
    are simply not re-registered, never an error."""
    from .controller import get_spatial_controller

    controller = get_spatial_controller()
    plane = getattr(controller, "queryplane", None)
    if plane is None:
        return 0, 0
    return plane.restore_rows(rows, source)
