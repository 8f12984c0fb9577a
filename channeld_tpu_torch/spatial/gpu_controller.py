"""GPUSpatialController: the device-backed spatial controller on torch.

The port of ``channeld_tpu/spatial/tpu_controller.py``
(``TPUSpatialController``). Config-selected exactly like the static host
controller (ref: spatial.go:65-69 — the SpatialController interface is
the plugin boundary). It registers under its own name and under
``TPUSpatialController``, the name the repo's ``spatial_tpu_*.json``
configs select the device-backed controller by, so those configs run
unchanged on this package's gateway:

    {"SpatialControllerType": "TPUSpatialController", "Config": {...}}

The engine lives on ``global_settings.spatial_device`` (``cuda`` unless
``-spatial-device cpu``), and its kernels are built in ``load_config``,
before listeners open. One device only: a mesh (``MeshDevices``,
``MeshHosts``), ``Sharding: "cells"`` or ``CellBucket`` raise
NotImplementedError.

Inherits all control-plane behavior (channel creation, regions, border
subscriptions, AOI query host semantics) from StaticGrid2DSpatialController
and moves the per-tick *decision plane* onto the device:

- ``notify`` no longer compares cells per entity on the host; it records
  the entity's new position in the SpatialEngine slot arrays.
- Once per GLOBAL-channel tick, one batched device step recomputes cell
  assignment for every entity and compacts boundary crossings; each
  crossing then runs the exact same handover orchestration as the host
  path (owner swap -> entity-table move -> handover fan-out).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..chaos.injector import chaos as _chaos
from ..core.device_guard import guard as _guard
from ..core.failover import journal as _journal
from ..core.overload import governor as _governor
from .balancer import balancer as _balancer
from ..core.settings import global_settings
from ..core.tracing import recorder as _trace
from ..utils.logger import get_logger
from .controller import SpatialInfo, register_spatial_controller_type
from .grid import StaticGrid2DSpatialController

logger = get_logger("spatial.gpu")


class GPUSpatialController(StaticGrid2DSpatialController):
    def __init__(self):
        super().__init__()
        self.engine = None
        # entity id -> provider returning the notifying entity id, captured
        # from the most recent position update (used at batch-detect time).
        self._providers: dict[int, Callable[[int, int], Optional[int]]] = {}
        self._last_positions: dict[int, SpatialInfo] = {}
        # Position before the latest update — the TRUE old position for
        # handover orchestration (logic like the reference's position-delta
        # check, pkg/unreal/handover.go:8-47, needs real coordinates, not
        # a synthetic cell center).
        self._prev_positions: dict[int, SpatialInfo] = {}
        # Auto-following interests (channeld-tpu extension): conn_id ->
        # (connection, follow_entity_id, kind, extent, direction, angle).
        self._followers: dict[int, tuple] = {}
        # Device fan-out plane (ref: data.go:175-291 — hot loop #2, now
        # batched). Due decisions are published into per-channel pending
        # queues (slot -> engine seq) so each spatial channel consumes
        # exactly its own due set — O(own due) per tick, and a decision a
        # channel hasn't consumed yet survives subsequent engine ticks
        # (the device advances the sub's window unconditionally, so a
        # dropped bit would silently slip that sub's fan-out a full
        # interval).
        self._due_seq = 0
        self._slot_channel: dict[int, int] = {}
        self._due_pending: dict[int, dict[int, int]] = {}  # ch_id -> {slot: seq}
        self._device_sub_count = 0
        self._shed_logged: dict[str, float] = {}  # table -> last log time
        # Overload deferrals (doc/overload.md): crossings past the L2+
        # per-tick orchestration cap wait here, keyed by entity so a
        # chain of deferred moves collapses into ONE crossing from the
        # cell the entity's channel data actually lives in to its
        # current cell (bounded at one entry per entity, never stale:
        # old_info stays pinned to the last orchestrated cell while
        # new_info follows the entity). Follower-interest passes
        # alternate ticks at L2+.
        self._deferred_crossings: dict[int, tuple] = {}
        self._follow_skip = False
        # _data_cell: inherited — the placement ledger lives on the
        # base grid controller (host gateways need the same exactness).
        # Device micro grid (adaptive partitioning, doc/partitioning.md):
        # the engine always serves a UNIFORM grid — the cell tree's
        # micro grid at its deepest active split. Device cell indices
        # are micro indices; ``_micro_leaf`` maps each back to the leaf
        # channel that owns it. With no splits the micro grid IS the
        # base grid and the mapping is identity — the legacy path
        # bit-for-bit.
        self._mcols = 0
        self._mrows = 0
        self._mw = 0.0
        self._mh = 0.0
        self._micro_leaf: Optional[list[int]] = None
        # Standing-query plane (spatial/queryplane.py;
        # doc/query_engine.md): None = disabled, the legacy per-follower
        # batch-readback path serves follows and client queries stay
        # host-evaluated per message.
        self.queryplane = None
        # Simulation plane (channeld_tpu_torch/sim; doc/simulation.md): None =
        # disabled, no agent population, every hook below is one None
        # check.
        self.simplane = None

    def load_config(self, config: dict) -> None:
        import time as _time

        # The controller Config's MeshDevices/MeshHosts keys win over the
        # -mesh-devices/-mesh-hosts flags; a mesh belongs to the
        # multi-device planes, which this package does not have yet.
        mesh_devices = int(config.get("MeshDevices",
                                      global_settings.tpu_mesh_devices))
        mesh_hosts = int(config.get("MeshHosts",
                                    global_settings.tpu_mesh_hosts))
        if mesh_devices > 0 or mesh_hosts > 1:
            raise NotImplementedError(
                "a meshed spatial engine belongs to the multi-device "
                "planes, which this package does not have yet"
            )
        super().load_config(config)
        from ..ops.engine import SpatialEngine
        from ..ops.spatial_ops import GridSpec

        # channel_removed -> untrack_entity is registered by the base
        # grid controller's load_config (polymorphic: the device-side
        # cleanup in our untrack_entity override still runs).

        # Sharding/CellBucket select the cells-sharded plane, which the
        # engine refuses (NotImplementedError) like a mesh.
        self._refresh_micro()
        t0 = _time.monotonic()
        self.engine = SpatialEngine(
            GridSpec(
                offset_x=self.world_offset_x,
                offset_z=self.world_offset_z,
                cell_w=self._mw,
                cell_h=self._mh,
                cols=self._mcols,
                rows=self._mrows,
            ),
            entity_capacity=global_settings.tpu_entity_capacity,
            query_capacity=global_settings.tpu_query_capacity,
            sharding=str(config.get("Sharding", "entities")),
            cell_bucket=int(config.get("CellBucket", 0)),
            query_rows_max=global_settings.queryplane_rows_max,
            device=global_settings.spatial_device,
        )
        if global_settings.queryplane_enabled:
            from .queryplane import QueryPlane

            # Created BEFORE warmup so the warmup tick also compiles the
            # on-device diff/compaction step.
            self.queryplane = QueryPlane(self, self.engine)
        # Build the kernels and run the first tick before listeners
        # open: a cold nvcc build inside a guarded step would miss the
        # watchdog deadline and read as a hang.
        self.engine.warmup()
        if global_settings.sim_enabled:
            # On-device world simulation (channeld_tpu_torch/sim;
            # doc/simulation.md): spawn/restore the agent population and
            # warm the sim step — still before listeners open.
            from ..sim.plane import SimPlane

            self.simplane = SimPlane(self, self.engine)
            self.simplane.activate()
        logger.info(
            "spatial engine on %s: kernels built and warmed in load_config "
            "(%.2fs)", self.engine.device, _time.monotonic() - t0,
        )

    # ---- decision plane --------------------------------------------------

    def _shed(self, table: str, detail: str) -> None:
        """Capacity-overflow policy: degrade visibly, never raise into the
        channel tick (a full world must keep ticking). Metric always;
        security log throttled per table (the shed condition repeats
        every update while the table stays full)."""
        import time as _time

        from ..core import metrics
        from ..utils.logger import security_logger

        metrics.tpu_capacity_shed.labels(table=table).inc()
        now = _time.monotonic()
        if now - self._shed_logged.get(table, -1e9) >= 5.0:
            self._shed_logged[table] = now
            security_logger().warning(
                "device %s table full: %s (degraded to host path; "
                "tpu_capacity_shed counts every occurrence)", table, detail
            )

    def notify(self, old_info, new_info, handover_data_provider) -> None:
        """Record the movement; detection happens in the batched tick."""
        entity_id = handover_data_provider(-1, -1)
        if entity_id is None:
            return
        if self.engine.slot_of_entity(entity_id) is None:
            # No device slot — first sighting, OR a previously shed entity
            # being re-adopted after capacity freed. Either way the slot's
            # prev-cell must be seeded from the *old* position, or this
            # very crossing is undetectable (detect_handovers needs
            # old_cell >= 0).
            try:
                slot = self.engine.add_entity(
                    entity_id, new_info.x, new_info.y, new_info.z
                )
            except RuntimeError:
                # Entity table full: this entity's handovers run the host
                # orchestration per-notify (the reference's only path,
                # spatial.go:612-626) until slots free up.
                self._shed("entity", f"entity {entity_id}")
                StaticGrid2DSpatialController.notify(
                    self, old_info, new_info, handover_data_provider
                )
                return
            try:
                self.engine.seed_cell(slot, self._micro_index(old_info))
            except ValueError:
                pass  # old position outside the world: no baseline
        try:
            self.engine.update_entity(
                entity_id, new_info.x, new_info.y, new_info.z
            )
        except RuntimeError:
            # Tracked host-side but shed from the device table earlier
            # (track_entity at capacity): host orchestration per-notify.
            self._shed("entity", f"entity {entity_id}")
            StaticGrid2DSpatialController.notify(
                self, old_info, new_info, handover_data_provider
            )
            return
        prev = self._last_positions.get(entity_id)
        if prev is None and old_info is not None:
            prev = old_info  # first sighting: the caller's old position
        if prev is not None:
            self._prev_positions[entity_id] = prev
        if entity_id not in self._data_cell and old_info is not None:
            # Authoritative placement ledger: the entity's channel data
            # lives where it was before this move. Seeded here (and in
            # track_entity) so even the FIRST crossing orchestrates from
            # the true cell — under cells-plane bucket overflow the
            # engine can report a crossing with a stale src, and a
            # remove aimed at the wrong channel leaves a duplicate.
            try:
                self._data_cell[entity_id] = self.get_channel_id(old_info)
            except ValueError:
                pass
        self._last_positions[entity_id] = new_info
        self._providers[entity_id] = handover_data_provider

    def _seed_baseline_cell(self, entity_id: int, info: SpatialInfo) -> None:
        """Set the device prev-cell for a just-sighted entity so a crossing
        in the same tick window starts from a real baseline, not -1."""
        slot = self.engine.slot_of_entity(entity_id)
        if slot is None:
            return
        try:
            self.engine.seed_cell(slot, self._micro_index(info))
        except ValueError:
            pass  # outside the world: no baseline

    def observe_entity(self, entity_id: int, info: SpatialInfo,
                       handover_data_provider=None) -> None:
        """Register/update an entity WITHOUT the handover path — fired by
        entity merges whose position didn't change (the reference never
        Notifies on an unmoved update, but this controller's tracking and
        follow-interest centering are fed by updates, so a stationary
        entity must still be seen)."""
        # Slot-existence, not host tracking: a shed entity being re-adopted
        # after capacity freed needs its baseline seeded like a first
        # sighting (an unseeded prev-cell of -1 hides its next crossing).
        fresh_slot = self.engine.slot_of_entity(entity_id) is None
        try:
            self.engine.update_entity(entity_id, info.x, info.y, info.z)
        except RuntimeError:
            self._shed("entity", f"entity {entity_id}")
        else:
            if fresh_slot:
                self._seed_baseline_cell(entity_id, info)
        self._last_positions.setdefault(entity_id, info)
        if handover_data_provider is not None:
            self._providers.setdefault(entity_id, handover_data_provider)

    def track_entity(self, entity_id: int, info: SpatialInfo) -> None:
        try:
            self.engine.add_entity(entity_id, info.x, info.y, info.z)
        except RuntimeError:
            # Stays host-tracked: follow centering and handover still work
            # (notify degrades per-entity); the world keeps ticking.
            self._shed("entity", f"entity {entity_id}")
        try:
            self._data_cell.setdefault(entity_id, self.get_channel_id(info))
        except ValueError:
            pass  # outside the world: no authoritative placement yet
        self._last_positions[entity_id] = info

    def untrack_entity(self, entity_id: int) -> None:
        self.engine.remove_entity(entity_id)
        self._last_positions.pop(entity_id, None)
        self._prev_positions.pop(entity_id, None)
        self._providers.pop(entity_id, None)
        self._deferred_crossings.pop(entity_id, None)
        # Shared cleanup (placement ledger, journal, balancer freezes)
        # lives on the base grid controller.
        super().untrack_entity(entity_id)

    # on_cell_rehosted / _note_entity_data_moved: inherited — the
    # placement ledger lives on the base grid controller now (host
    # gateways need the same exactness; doc/global_control.md).

    def entity_position(self, entity_id: int):
        """Partition-plane hook: the split commit sorts residents into
        child quadrants by last known position (None -> deterministic
        center-child fallback)."""
        info = self._last_positions.get(entity_id)
        return (info.x, info.z) if info is not None else None

    # ---- device micro grid (adaptive partitioning) -----------------------

    def _refresh_micro(self) -> None:
        """Recompute the micro grid spec + micro->leaf map from the cell
        tree. Depth 0 (or no tree) degenerates to the base grid with an
        identity mapping."""
        tree = getattr(self, "tree", None)
        if tree is None:
            self._mcols, self._mrows = self.grid_cols, self.grid_rows
            self._mw, self._mh = self.grid_width, self.grid_height
            self._micro_leaf = None
            return
        _d, mcols, mrows, mw, mh = tree.micro_spec()
        self._mcols, self._mrows = mcols, mrows
        self._mw, self._mh = mw, mh
        self._micro_leaf = tree.micro_to_leaf() if tree.splits else None

    def _micro_index(self, info) -> int:
        """Device (micro) cell index of a world position; ValueError
        outside the grid. Divide-then-floor, matching the device's
        assign_cells exactly — these values feed device baselines."""
        import math

        col = math.floor((info.x - self.world_offset_x) / self._mw)
        row = math.floor((info.z - self.world_offset_z) / self._mh)
        if not (0 <= col < self._mcols and 0 <= row < self._mrows):
            raise ValueError("position outside the grid")
        return row * self._mcols + col

    def _leaf_of_cell(self, cell: int) -> int:
        """Leaf channel id owning one device micro cell."""
        if self._micro_leaf is not None and 0 <= cell < len(self._micro_leaf):
            return self._micro_leaf[cell]
        return global_settings.spatial_channel_id_start + cell

    def _micro_of_channel(self, ch_id: int, entity_id: int = None) -> int:
        """Device baseline micro cell for an entity whose data lives in
        ``ch_id``: the micro cell of its last position when that still
        lies inside the leaf, else the leaf's center micro cell."""
        tree = getattr(self, "tree", None)
        if tree is None or self._micro_leaf is None:
            return ch_id - global_settings.spatial_channel_id_start
        if entity_id is not None:
            info = self._last_positions.get(entity_id)
            if info is not None:
                try:
                    m = self._micro_index(info)
                    if self._leaf_of_cell(m) == ch_id:
                        return m
                except ValueError:
                    pass
        try:
            x, z = tree.center(ch_id)
        except ValueError:
            return -1
        return self._micro_index(SpatialInfo(x, 0, z))

    def _channel_center(self, ch_id: int) -> SpatialInfo:
        """World-space center of one spatial CHANNEL (any depth)."""
        tree = getattr(self, "tree", None)
        if tree is not None:
            x, z = tree.center(ch_id)
            return SpatialInfo(x, 0, z)
        return self._cell_center(
            ch_id - global_settings.spatial_channel_id_start
        )

    def on_geometry_changed(self) -> None:
        """A geometry epoch committed (spatial/partition.py apply path or
        WAL/snapshot restore): re-mirror the cell tree onto the device.
        A same-depth change only swaps the host-side micro->leaf map; a
        depth change rebuilds the device arrays onto the new micro grid
        through the supervised-rebuild machinery (generation-fenced
        against watchdog-abandoned steps) and verifies the rebuilt
        arrays bit-identical to the host shadow."""
        old = (self._mcols, self._mrows)
        self._refresh_micro()
        if self.engine is None:
            return
        if (self._mcols, self._mrows) == old:
            # Same micro grid; only the leaf mapping moved — but that
            # remap still invalidates the sim plane's FLEE mask (it is
            # keyed by micro index via leaf hits).
            if self.simplane is not None:
                self.simplane.on_geometry()
            return
        from ..core import metrics
        from ..ops.spatial_ops import GridSpec

        seeds = self.rebuild_seed_cells()
        self.engine.apply_grid(
            GridSpec(
                offset_x=self.world_offset_x,
                offset_z=self.world_offset_z,
                cell_w=self._mw,
                cell_h=self._mh,
                cols=self._mcols,
                rows=self._mrows,
            ),
            seeds,
        )
        if self.simplane is not None:
            # Depth change: the device arrays rebuilt onto the new micro
            # grid (agent rows re-uploaded from the host shadow by the
            # same path); re-rasterize the FLEE mask onto it.
            self.simplane.on_geometry()
        errors = self.engine.verify_device_state(seeds)
        metrics.partition_device_rebuilds.labels(
            result="verified" if not errors else "mismatch"
        ).inc()
        if errors:
            logger.error(
                "geometry epoch %d device rebuild NOT bit-identical: %s",
                self.geometry_epoch, "; ".join(errors),
            )
            if _trace.enabled:
                _trace.note_anomaly(
                    "geometry_rebuild_mismatch",
                    f"epoch {self.geometry_epoch}: " + "; ".join(errors),
                    force=True,
                )
        else:
            logger.info(
                "geometry epoch %d: device micro grid now %dx%d "
                "(%.3gx%.3g cells), rebuild verified bit-identical",
                self.geometry_epoch, self._mcols, self._mrows,
                self._mw, self._mh,
            )

    # ---- device supervision hooks (core/device_guard.py) -----------------

    def on_device_fatal(self, cause: str) -> None:
        """The engine just failed fatally. Deferred crossings came from
        a possibly-corrupt engine AND will be re-detected from the
        rebuilt baseline anyway (each entity's data stays in its last
        orchestrated cell; the reseed makes the next tick re-report any
        move since) — dropping them here is lossless and deterministic.
        In-flight journal transactions are host-side channel hops that
        complete on their own; the rebuild seeding honors them via
        ``pending_dst`` (doc/device_recovery.md)."""
        if self._deferred_crossings:
            logger.warning(
                "device %s: dropping %d deferred crossings (re-detected "
                "after rebuild)", cause, len(self._deferred_crossings),
            )
            self._deferred_crossings.clear()

    def rebuild_seed_cells(self) -> dict[int, int]:
        """{engine slot: cell index} baselines for the in-process engine
        rebuild — where each entity's channel data authoritatively
        lives right now. The failover journal's in-flight dst outranks
        the committed ``_data_cell`` ledger (mid-flight, the data is
        bound for the pending dst); entities with neither fall back to
        their last known position (first sighting that never
        orchestrated). The rebuilt engine re-detects any movement since
        from these baselines, so an outage never loses a crossing.

        Cell indices are MICRO-grid indices (identical to base-grid
        indices until a split is live; doc/partitioning.md)."""
        seeds: dict[int, int] = {}
        for entity_id, slot in self.engine.tracked_entities():
            ch_id = _journal.pending_dst(entity_id)
            if ch_id is None:
                ch_id = self._data_cell.get(entity_id)
            if ch_id is None:
                info = self._last_positions.get(entity_id)
                if info is not None:
                    try:
                        ch_id = self.get_channel_id(info)
                    except ValueError:
                        ch_id = None
            seeds[slot] = (
                self._micro_of_channel(ch_id, entity_id)
                if ch_id is not None else -1
            )
        return seeds

    # ---- device fan-out plane --------------------------------------------

    def device_sub_add(
        self, interval_ms: int, delay_ms: int, channel_id: int
    ) -> Optional[int]:
        """Register a spatial-channel subscription in the engine sub table;
        None when the engine isn't up or the table is full (the caller
        falls back to the host time check)."""
        if self.engine is None:
            return None
        try:
            now = self.engine.now_ms()
            slot = self.engine.add_subscription(
                interval_ms, first_due_ms=now + delay_ms
            )
        except RuntimeError:
            return None
        self._slot_channel[slot] = channel_id
        self._device_sub_count += 1
        return slot

    def device_sub_remove(self, slot: int) -> None:
        if self.engine is not None:
            self.engine.remove_subscription(slot)
            ch_id = self._slot_channel.pop(slot, None)
            if ch_id is not None:
                self._due_pending.get(ch_id, {}).pop(slot, None)
            self._device_sub_count -= 1

    def device_sub_set_interval(self, slot: int, interval_ms: int) -> None:
        if self.engine is not None:
            self.engine.set_sub_interval(slot, interval_ms)

    def device_sub_first_fanout(self, slot: int) -> None:
        if self.engine is not None:
            self.engine.reset_sub_clock(slot, self.engine.now_ms())

    def device_due(self, channel_id: int) -> Optional[tuple[int, dict]]:
        """(engine_tick_seq, pending {slot: seq}) for one channel; the
        caller pops entries as it serves them (single consumption). None
        before the first engine tick (host fallback)."""
        if self._due_seq == 0:
            return None
        return self._due_seq, self._due_pending.setdefault(channel_id, {})

    def _publish_due(self, result) -> None:
        import numpy as np

        self._due_seq += 1
        # The due bits of the tick's consume blob (parsed once, cached on
        # the result: no transfer beyond the tick's one).
        due = self.engine.consume(result)[3]
        for slot in np.nonzero(due)[0].tolist():
            ch_id = self._slot_channel.get(slot)
            if ch_id is not None:
                self._due_pending.setdefault(ch_id, {})[slot] = self._due_seq

    # ---- auto-following interest (channeld-tpu extension) ----------------

    def register_follow_interest(
        self, conn, follow_entity_id: int, kind: int,
        extent=(0.0, 0.0), direction=(1.0, 0.0), angle: float = 0.0,
    ) -> None:
        """The connection's AOI query tracks ``follow_entity_id`` on device:
        every batched tick re-centers the query on the entity's position
        and re-diffs the spatial subscriptions from the interest mask —
        no per-move UPDATE_SPATIAL_INTEREST messages needed."""
        info = self._last_positions.get(follow_entity_id)
        center = (info.x, info.z) if info is not None else (0.0, 0.0)
        try:
            self.engine.set_query(conn.id, kind, center, extent, direction,
                                  angle)
        except RuntimeError:
            # Query table full: shed the auto-follow — the client keeps
            # whatever explicit interest it has (UPDATE_SPATIAL_INTEREST
            # stays host-served) instead of crashing the handler.
            self._shed("query", f"conn {conn.id} follow {follow_entity_id}")
            return
        self._followers[conn.id] = {
            "conn": conn, "entity": follow_entity_id, "kind": kind,
            "extent": extent, "direction": direction, "angle": angle,
            "center": center,
        }
        if self.queryplane is not None:
            self.queryplane.bind_follow(conn, follow_entity_id, kind,
                                        center, extent, direction, angle)

    def unregister_follow_interest(self, conn_id: int) -> None:
        if self._followers.pop(conn_id, None) is not None:
            if self.queryplane is not None:
                # Frees the engine row AND zeroes its diff baseline —
                # no dead row stays in the batched pass, and a reused
                # row can't leak the old mask (bounded-registry
                # discipline; the row-reuse hazard is pinned by
                # tests/test_queryplane.py churn coverage).
                self.queryplane.deregister(conn_id)
            else:
                self.engine.remove_query(conn_id)

    def _reap_followers(self) -> None:
        from ..spatial.messages import apply_interest_diff

        for conn_id, entry in list(self._followers.items()):
            if entry["conn"].is_closing():
                self.unregister_follow_interest(conn_id)
                continue
            tracked = entry["entity"] in self._last_positions
            if tracked:
                entry["seen"] = True
            elif entry.get("seen"):
                # The followed entity WAS tracked and is now gone
                # (destroyed / untracked): a stale frozen center would
                # stream the wrong cells to the client forever. Drop the
                # interest entirely — the client re-queries (or
                # re-follows) on respawn. A follow registered before the
                # entity's first position update is NOT reaped (grace:
                # "seen" is only set once the entity appears).
                self.unregister_follow_interest(conn_id)
                apply_interest_diff(entry["conn"], {})
        if self.queryplane is not None:
            # Client-scope standing rows ride connections too: reap the
            # closed ones so the device pass stays bounded by LIVE
            # registrations under churn.
            self.queryplane.reap_closed()

    def collapse_micro_cells(self, desired: dict[int, int]) -> dict[int, int]:
        """{micro_cell: dist} -> {leaf_channel_id: dist}. Micro cells
        collapse onto leaf CHANNELS; several micro cells of one leaf ->
        keep the closest distance (interest priority is distance-ranked).
        Identity (+ id offset) while no split is live."""
        start = global_settings.spatial_channel_id_start
        if self._micro_leaf is None:
            return {start + cell: dist for cell, dist in desired.items()}
        wanted: dict[int, int] = {}
        for cell, dist in desired.items():
            ch = self._leaf_of_cell(cell)
            if ch not in wanted or dist < wanted[ch]:
                wanted[ch] = dist
        return wanted

    def _recenter_followers(self) -> None:
        """Re-center each follow query on its entity for the *next*
        tick; skips the query-table write when the entity hasn't moved
        (the table upload is O(capacity))."""
        for conn_id, entry in list(self._followers.items()):
            if entry["conn"].is_closing():
                continue  # _reap_followers owns removal
            info = self._last_positions.get(entry["entity"])
            if info is not None and (info.x, info.z) != entry["center"]:
                self.engine.set_query(
                    conn_id, entry["kind"], (info.x, info.z),
                    entry["extent"], entry["direction"], entry["angle"],
                )
                entry["center"] = (info.x, info.z)

    def register_sensor(self, name: str, **kwargs):
        """Server-facing standing sensor (spatial/queryplane.py): a named
        AOI query with no connection, evaluated in the same batched
        device pass as every follower and client query. Returns the
        sensor key, or None when the plane is disabled or the query
        table is full."""
        if self.queryplane is None:
            return None
        return self.queryplane.register_sensor(name, **kwargs)

    def _apply_follow_interests(self, result) -> None:
        import time as _time

        from ..core import metrics
        from ..spatial.messages import apply_interest_diff

        live: list[int] = []
        for conn_id, entry in list(self._followers.items()):
            conn = entry["conn"]
            if conn.is_closing():
                self.unregister_follow_interest(conn_id)
                continue
            live.append(conn_id)
        self._recenter_followers()
        if not live:
            return
        # ONE device->host transfer of the whole interest/dist tables for
        # every follower (ROADMAP item 1: the per-follower row readback
        # measured ~330us each — linear in followers, the single biggest
        # live-gateway host cost); the per-follower diff runs on host
        # slices. follower_readbacks now counts BATCHED transfers — one
        # per pass, not one per follower.
        rb0 = _time.monotonic_ns()
        desired_all = self.engine.interested_cells_batch(result, live)
        readback_ns = _time.monotonic_ns() - rb0
        metrics.follower_readbacks.inc()
        _trace.stage("readback", rb0, end_ns=rb0 + readback_ns)
        for conn_id in live:
            entry = self._followers.get(conn_id)
            if entry is None:
                continue
            wanted = self.collapse_micro_cells(desired_all.get(conn_id, {}))
            apply_interest_diff(entry["conn"], wanted)

    def tick(self) -> None:
        super().tick()  # reap closed server connections
        if self.engine is None:
            return
        self._reap_followers()  # even with no entities tracked
        # A tick is needed when entities move OR device-registered fan-out
        # subscriptions exist (due decisions come from the engine even for
        # an entity-less spatial world, e.g. pure chat-over-spatial) OR
        # standing queries are registered (a sensor over a static world
        # still needs its first evaluation + epoch re-applies).
        if (self.engine.entity_count() == 0 and self._device_sub_count == 0
                and (self.queryplane is None
                     or self.queryplane.count() == 0)):
            return
        from ..core import metrics

        import time as _time

        t0 = _time.monotonic()
        if _chaos.armed:
            # Chaos: a slow device dispatch (compilation hiccup, busy
            # chip, thermal step-down). The tick must absorb it —
            # degradation shows in tpu_step_latency / tick p99, never as
            # an exception into the channel tick.
            stall = _chaos.stall_s("device.dispatch_stall")
            if stall:
                _time.sleep(stall)  # tpulint: disable=async-blocking -- chaos-injected dispatch stall MODELS a busy chip stalling the tick (doc/chaos.md); blocking is the point
        if self.simplane is not None:
            # Sim cadence/chaos decisions for THIS tick (sets the
            # engine's run_sim_pass/sim_census_due flags; the agent step
            # itself runs inside the guarded device tick below).
            self.simplane.pre_step()
        if _guard.enabled:
            # Supervised step (doc/device_recovery.md): watchdog +
            # transient retry + sentinel + in-process rebuild. None =
            # the engine is down/held this tick — every device-
            # dependent stage below (due publish, crossing
            # orchestration, follower pass) waits; host-side work
            # (server reaping, follower registry upkeep) already ran.
            result = _guard.run_step(self)
            if result is None:
                return
        else:
            result = self.engine.tick()
        handovers = self.engine.handover_list(result)
        metrics.tpu_step_latency.observe(_time.monotonic() - t0)
        # Same window as tpu_step_latency: dispatch + device step + the
        # handover-list readback.
        _trace.stage("device_step", int(t0 * 1e9))
        metrics.tpu_entities.set(self.engine.entity_count())
        if self.simplane is not None:
            # Census-cadence absorb/journal/commit (a no-op on every
            # non-census tick beyond one counter diff).
            self.simplane.on_result(result)
        self._publish_due(result)
        if handovers or self._deferred_crossings:
            # Batched orchestration: one owner-swap/remove-add/fan-out
            # pass per (src,dst) cell pair, not per crossing — the device
            # detects ~1.5K crossings per tick and per-crossing host
            # orchestration measured 3.9x slower than the detection rate
            # (scripts/bench_handover.py).
            pending = self._deferred_crossings
            for e, s, d in handovers:
                if (self._micro_leaf is not None
                        and self._leaf_of_cell(s) == self._leaf_of_cell(d)):
                    # Intra-leaf micro crossing: the device grid is finer
                    # than the channel geometry here (an unsplit neighbor
                    # pins the micro depth); no channel boundary crossed,
                    # nothing to orchestrate.
                    continue
                if (self.simplane is not None
                        and self.engine.is_agent(e)
                        and not self.simplane.authority.is_backed(e)):
                    # Engine-only agent (past the sim_channel_agents
                    # cap, or its cell channel is still booting): no
                    # channel data lives anywhere, so there is nothing
                    # to orchestrate — the device cell tracking alone is
                    # authoritative for it (doc/simulation.md).
                    continue
                prev = pending.get(e)
                if prev is not None:
                    # Chain: the entity's data still lives where the
                    # first deferred crossing left from; keep that
                    # origin, orchestrate straight to the newest
                    # destination (in-place update preserves the
                    # entry's FIFO position).
                    _, new_info, provider = self._build_crossing(e, s, d)
                    pending[e] = (prev[0], new_info, provider)
                    continue
                old_info, new_info, provider = self._build_crossing(e, s, d)
                # The transactional journal outranks the committed
                # ledger: mid-flight, the entity's data is bound for the
                # pending dst even though _data_cell still says src
                # (it only flips on commit, in the dst cell's tick).
                pend_dst = _journal.pending_dst(e)
                if pend_dst is not None:
                    if pend_dst == self._leaf_of_cell(d):
                        # Stale re-detection of the in-flight move.
                        continue
                    # Chained hop: orchestrate from where the in-flight
                    # txn will land (FIFO on that channel's queue puts
                    # the new remove after the pending add).
                    pending[e] = (
                        self._channel_center(pend_dst),
                        new_info, provider,
                    )
                    continue
                known = self._data_cell.get(e)
                if known is not None:
                    if known == self._leaf_of_cell(d):
                        # Stale re-detection (cells-plane re-offer): the
                        # data already lives in the destination.
                        continue
                    if known != self._leaf_of_cell(s):
                        old_info = self._channel_center(known)
                pending[e] = (old_info, new_info, provider)
            cap = _governor.handover_batch_cap()
            if cap is None and len(pending) > len(handovers):
                # De-escalation with a deferred backlog: drain it over a
                # few ticks instead of all at once — an unbounded drain
                # right after stepping down was measured re-spiking the
                # tick budget and bouncing the ladder back up.
                cap = max(
                    1, global_settings.overload_handover_batch_cap
                ) * 8
            if cap is not None and len(pending) > cap:
                # L2+: orchestrate the oldest ``cap`` entities, defer the
                # rest to next tick — lossless (each entity keeps exactly
                # one pending crossing; the channel data stays in its
                # last orchestrated cell meanwhile), and every deferral-
                # tick is counted.
                batch_keys = list(pending)[:cap]
                batch = [pending.pop(k) for k in batch_keys]
                _governor.count_shed("handover_defer", len(pending))
            else:
                batch = list(pending.values())
                pending.clear()
            t_ho = _time.monotonic()
            StaticGrid2DSpatialController.notify_crossings(self, batch)
            _governor.note_handover_cost(_time.monotonic() - t_ho)
            _trace.stage("handover", int(t_ho * 1e9))
        if self.queryplane is not None:
            # Standing-query plane (doc/query_engine.md): ONE changed-
            # rows consume per tick, apply O(changed). The CONSUME always
            # drains — the device already committed this tick's baseline,
            # so an unconsumed blob is a permanently lost delta; at L2+
            # only the APPLY pass (and follower re-centering) alternates
            # ticks, halving standing-query cadence exactly as the
            # legacy follower path halves.
            defer = _governor.level >= 2 and not self._follow_skip
            t_fi = _time.monotonic()
            if defer:
                self._follow_skip = True
                # An empty registry sheds nothing — a zero count would
                # still create the ledger key and break the soaks'
                # exact shed accounting.
                if self.queryplane.count():
                    _governor.count_shed(
                        "query_apply_defer", self.queryplane.count()
                    )
            else:
                self._follow_skip = False
                self._recenter_followers()
            self.queryplane.pump(result, apply=not defer)
            cost = _time.monotonic() - t_fi
            _trace.stage("query_plane", int(t_fi * 1e9))
            # Same pressure-signal input the legacy follower pass fed:
            # the plane's host cost is the follower cost now.
            metrics.follower_interest_ms.observe(cost * 1000.0)
            _governor.note_follower_cost(cost)
        elif self._followers:
            if _governor.level >= 2 and not self._follow_skip:
                # L2+: follower interests re-center every OTHER tick —
                # half the host cost, interest diffs lag one tick.
                self._follow_skip = True
                _governor.count_shed(
                    "follow_interest_defer", len(self._followers)
                )
            else:
                self._follow_skip = False
                t_fi = _time.monotonic()
                self._apply_follow_interests(result)
                cost = _time.monotonic() - t_fi
                _trace.stage("follow_interests", int(t_fi * 1e9))
                # The previously-unmeasured host cost inside the GLOBAL
                # tick budget (VERDICT weak #5): now a first-class
                # histogram and a pressure-signal input.
                metrics.follower_interest_ms.observe(cost * 1000.0)
                _governor.note_follower_cost(cost)

    def _build_crossing(self, entity_id: int, src_cell: int, dst_cell: int):
        """(old_info, new_info, provider) for one device-detected crossing."""
        provider = self._providers.get(entity_id)
        if provider is None:
            provider = lambda s, d: entity_id
        # Use the entity's TRUE previous position when it still maps to the
        # device-reported src cell (it can diverge when several moves
        # collapsed into one batched tick); the cell center is only the
        # consistency fallback. The orchestration recomputes src/dst from
        # the infos, so whichever is used must map back to src_cell.
        old_info = self._prev_positions.get(entity_id)
        if old_info is not None:
            try:
                mapped = self._micro_index(old_info)
            except ValueError:
                mapped = -1
            if mapped != src_cell:
                old_info = None
        if old_info is None:
            old_info = self._cell_center(src_cell)
        # Same consistency rule on the destination side: the host belief
        # can LAG the device for sim agents (their positions advance on
        # device every tick but _last_positions only refreshes at census
        # cadence), and a stale new_info that still maps to src would
        # collapse the crossing to s == d — dropped forever, since the
        # device baseline already committed to dst and never re-detects.
        new_info = self._last_positions.get(entity_id)
        if new_info is not None:
            try:
                mapped = self._micro_index(new_info)
            except ValueError:
                mapped = -1
            if mapped != dst_cell:
                new_info = None
        if new_info is None:
            new_info = self._cell_center(dst_cell)
        return old_info, new_info, provider

    def _run_handover(self, entity_id: int, src_cell: int, dst_cell: int) -> None:
        """Run the host orchestration for one device-detected crossing
        (kept for tests / tooling; the tick path batches via
        notify_crossings)."""
        old_info, new_info, provider = self._build_crossing(
            entity_id, src_cell, dst_cell
        )
        StaticGrid2DSpatialController.notify(self, old_info, new_info, provider)

    def _cell_center(self, cell: int) -> SpatialInfo:
        # MICRO-grid center (== base grid until a split is live).
        x = self.world_offset_x + (cell % self._mcols + 0.5) * self._mw
        z = self.world_offset_z + (cell // self._mcols + 0.5) * self._mh
        return SpatialInfo(x, 0, z)


register_spatial_controller_type("GPUSpatialController", GPUSpatialController)
register_spatial_controller_type("TPUSpatialController", GPUSpatialController)
