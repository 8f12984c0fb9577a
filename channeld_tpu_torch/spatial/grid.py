"""StaticGrid2D spatial controller — host-semantics implementation.

Capability parity with the reference controller
(ref: pkg/channeld/spatial.go:89-902): the world is GridCols x GridRows
base cells on the XZ plane; each spatial server owns a ServerCols x
ServerRows block plus an interest border of cells it subscribes to; AOI
queries (spots/box/sphere/cone) sample cells at half-cell steps and
return {channelId: grid-distance}; ``notify`` orchestrates cross-cell
(and cross-server) entity handover.

Cell geometry is a runtime, versioned property (doc/partitioning.md):
all channel-id, adjacency and server-placement math consults the live
:class:`~.celltree.CellTree`, which the adaptive partitioning plane
(spatial/partition.py) mutates through transactional geometry epochs.
With no splits active the tree reproduces the legacy static formulas
bit-for-bit — geometry tests pin the INVARIANTS (position->leaf
containment, neighbor-band adjacency, server inheritance), not one
fixed layout.

This module is the *semantic reference* path. The TPU decision plane
(channeld_tpu.ops / tpu_controller.py) computes cell assignment, AOI
masks and handover detection as batched device arrays and must agree
with this implementation — the geometry tests pin both.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from ..core.overload import governor as _governor
from ..core.settings import global_settings
from ..federation.directory import directory as _shard_directory
from .balancer import balancer as _balancer
from .celltree import CellTree
from .partition import partition as _partition
from ..core.types import ChannelType, ConnectionType, MessageType
from ..protocol import control_pb2, spatial_pb2
from ..utils.anyutil import pack_any
from ..utils.logger import get_logger
from .controller import SpatialInfo, register_spatial_controller_type

logger = get_logger("spatial.grid")

# Y bounds of a region (the grid is 2D; regions span all heights)
# (ref: spatial.go MinY/MaxY).
MIN_Y = -3.40282347e38 / 2
MAX_Y = 3.40282347e38 / 2


def _dist_2d(ax: float, az: float, bx: float, bz: float) -> float:
    return math.hypot(ax - bx, az - bz)


class StaticGrid2DSpatialController:
    """(ref: spatial.go:93-124)."""

    def __init__(self):
        self.grid_width = 0.0
        self.grid_height = 0.0
        self.grid_cols = 0
        self.grid_rows = 0
        self.world_offset_x = 0.0
        self.world_offset_z = 0.0
        self.server_cols = 0
        self.server_rows = 0
        self.server_interest_border_size = 0
        self.server_connections: list = []
        self._grid_size = 0.0
        # Live cell geometry (doc/partitioning.md): built at load_config,
        # mutated only through apply_geometry (the partition plane's
        # commit, trunk geometry sync, and WAL replay).
        self.tree: Optional[CellTree] = None
        # Authoritative placement ledger: entity id -> the spatial cell
        # channel whose DATA currently holds the entity. Crossing
        # detection works from positions (host) or the device prev-cell
        # table (TPU) — both can disagree with where the data actually
        # sits (an entity applied into a cell by a trunked handover or
        # an adoption bootstrap hasn't been position-sighted yet), and a
        # remove aimed at the wrong src cell leaves the data duplicated
        # across two cells. Flipped only when a move is REAL: the
        # orchestration commit hook, the federation apply/restore paths,
        # and the failover re-host re-seed.
        self._data_cell: dict[int, int] = {}

    # ---- config ----------------------------------------------------------

    def load_config(self, config: dict) -> None:
        self.grid_width = float(config.get("GridWidth", 0))
        self.grid_height = float(config.get("GridHeight", 0))
        self.grid_cols = int(config.get("GridCols", 0))
        self.grid_rows = int(config.get("GridRows", 0))
        self.world_offset_x = float(config.get("WorldOffsetX", 0))
        self.world_offset_z = float(config.get("WorldOffsetZ", 0))
        self.server_cols = int(config.get("ServerCols", 0))
        self.server_rows = int(config.get("ServerRows", 0))
        self.server_interest_border_size = int(
            config.get("ServerInterestBorderSize", 0)
        )
        if self.grid_width <= 0 or self.grid_height <= 0:
            raise ValueError("GridWidth and GridHeight should be positive")
        if self.grid_cols <= 0 or self.grid_rows <= 0:
            raise ValueError("GridCols and GridRows should be positive")
        if self.server_cols <= 0 or self.server_rows <= 0:
            raise ValueError("ServerCols and ServerRows should be positive")
        st = global_settings
        self.tree = CellTree(
            st.spatial_channel_id_start, self.grid_cols, self.grid_rows,
            self.grid_width, self.grid_height,
            self.world_offset_x, self.world_offset_z,
            max_depth=st.partition_max_depth,
        )
        # Id-space guard: every depth's cell block must fit under the
        # entity channel id space, or a deep split would mint ids that
        # collide with entity channels.
        if self.tree.id_space_end() > st.entity_channel_id_start:
            raise ValueError(
                f"partition_max_depth={st.partition_max_depth} needs cell "
                f"ids up to {self.tree.id_space_end()}, past the entity "
                f"id start {st.entity_channel_id_start}"
            )
        from ..core import events

        def _on_channel_removed(channel_id: int) -> None:
            if channel_id >= global_settings.entity_channel_id_start:
                self.untrack_entity(channel_id)

        events.channel_removed.listen_for(self, _on_channel_removed)

    def untrack_entity(self, entity_id: int) -> None:
        """The entity's channel is gone: drop its placement-ledger row
        (a reused entity id must never inherit the old row — notify()
        would re-route the new entity's remove at a cell that holds no
        copy, stranding the real one as a duplicate), moot any in-flight
        journal transaction, and clear balancer freeze state. The TPU
        subclass adds device-side cleanup on top."""
        from ..core.failover import journal as _journal

        self._data_cell.pop(entity_id, None)
        _journal.forget_entity(entity_id)
        _balancer._frozen_crossings.pop(entity_id, None)

    # ---- geometry --------------------------------------------------------

    def world_width(self) -> float:
        return self.grid_width * self.grid_cols

    def world_height(self) -> float:
        return self.grid_height * self.grid_rows

    def grid_size(self) -> float:
        """Cell diagonal, the unit of AOI distance (ref: spatial.go:137-142)."""
        if self._grid_size == 0 and self.grid_width > 0 and self.grid_height > 0:
            self._grid_size = math.hypot(self.grid_width, self.grid_height)
        return self._grid_size

    def get_channel_id(self, info: SpatialInfo) -> int:
        return self.get_channel_id_with_offset(
            info, self.world_offset_x, self.world_offset_z
        )

    def get_channel_id_no_offset(self, info: SpatialInfo) -> int:
        return self.get_channel_id_with_offset(info, 0.0, 0.0)

    def get_channel_id_with_offset(
        self, info: SpatialInfo, offset_x: float, offset_z: float
    ) -> int:
        """Position -> LIVE LEAF cell id. Base cell by the legacy
        formula start + floor((x-ox)/w) + floor((z-oz)/h)*cols
        (ref: spatial.go:169-180), then descended through any active
        splits. Raises ValueError outside the world."""
        gx = math.floor((info.x - offset_x) / self.grid_width)
        if gx < 0 or gx >= self.grid_cols:
            raise ValueError(f"gridX={gx} out of [0,{self.grid_cols}) for X={info.x}")
        gz = math.floor((info.z - offset_z) / self.grid_height)
        if gz < 0 or gz >= self.grid_rows:
            raise ValueError(f"gridY={gz} out of [0,{self.grid_rows}) for Z={info.z}")
        cell = global_settings.spatial_channel_id_start + gx + gz * self.grid_cols
        tree = self.tree
        if tree is None or not tree.splits:
            return cell
        rx, rz = info.x - offset_x, info.z - offset_z
        d = 0
        while cell in tree.splits:
            d += 1
            w = self.grid_width / (1 << d)
            h = self.grid_height / (1 << d)
            cgx = min(int(rx // w), (self.grid_cols << d) - 1)
            cgz = min(int(rz // h), (self.grid_rows << d) - 1)
            cell = tree.encode(d, cgx, cgz)
        return cell

    def base_cell_id(self, gx: int, gz: int) -> int:
        """Depth-0 (base-grid) cell id; raises outside the grid."""
        if gx < 0 or gx >= self.grid_cols:
            raise ValueError(f"gridX={gx} out of [0,{self.grid_cols})")
        if gz < 0 or gz >= self.grid_rows:
            raise ValueError(f"gridY={gz} out of [0,{self.grid_rows})")
        return global_settings.spatial_channel_id_start + gx + gz * self.grid_cols

    # ---- AOI queries -----------------------------------------------------

    def _sample_cell_size(self) -> tuple[float, float]:
        """AOI sampling granularity: the finest live cell (the micro
        grid's), so a box/sphere sweep cannot step over a split child.
        Equals the base cell size when no splits are active."""
        tree = self.tree
        if tree is None or not tree.splits:
            return self.grid_width, self.grid_height
        d = tree.max_active_depth()
        return self.grid_width / (1 << d), self.grid_height / (1 << d)

    def query_channel_ids(self, query: spatial_pb2.SpatialInterestQuery) -> dict[int, int]:
        """{channelId: distance in grid-diagonal units}; 0 = nearest
        (ref: spatial.go:182-317)."""
        if query is None:
            raise ValueError("query is nil")
        result: dict[int, int] = {}
        samp_w, samp_h = self._sample_cell_size()

        if query.HasField("spotsAOI"):
            for i, spot in enumerate(query.spotsAOI.spots):
                try:
                    ch_id = self.get_channel_id(SpatialInfo(spot.x, spot.y, spot.z))
                except ValueError:
                    continue
                if i < len(query.spotsAOI.dists):
                    result[ch_id] = query.spotsAOI.dists[i]
                else:
                    result[ch_id] = 0

        if query.HasField("boxAOI"):
            box = query.boxAOI
            cx, cz = box.center.x, box.center.z
            step_z = min(box.extent.z, samp_h) * 0.5
            if step_z <= 0:
                raise ValueError(f"invalid box extentZ={box.extent.z}")
            step_x = min(box.extent.x, samp_w) * 0.5
            if step_x <= 0:
                raise ValueError(f"invalid box extentX={box.extent.x}")
            z = cz - box.extent.z
            while z <= cz + box.extent.z:
                x = cx - box.extent.x
                while x <= cx + box.extent.x:
                    self._add_sample(result, cx, cz, x, z)
                    x += step_x
                z += step_z
            result[self.get_channel_id(SpatialInfo(cx, 0, cz))] = 0

        if query.HasField("sphereAOI"):
            r = query.sphereAOI.radius
            cx, cz = query.sphereAOI.center.x, query.sphereAOI.center.z
            step_z = min(r, samp_h) * 0.5
            step_x = min(r, samp_w) * 0.5
            if step_z <= 0 or step_x <= 0:
                raise ValueError(f"invalid radius={r}")
            z = cz - r
            while z <= cz + r:
                x = cx - r
                while x <= cx + r:
                    if (x - cx) ** 2 + (z - cz) ** 2 <= r * r:
                        self._add_sample(result, cx, cz, x, z)
                    x += step_x
                z += step_z
            result[self.get_channel_id(SpatialInfo(cx, 0, cz))] = 0

        if query.HasField("coneAOI"):
            cone = query.coneAOI
            r = cone.radius
            cx, cz = cone.center.x, cone.center.z
            dx, dz = cone.direction.x, cone.direction.z
            dlen = math.hypot(dx, dz)
            if dlen > 0:
                dx, dz = dx / dlen, dz / dlen
            step_z = min(r, samp_h) * 0.5
            step_x = min(r, samp_w) * 0.5
            if step_z <= 0 or step_x <= 0:
                raise ValueError(f"invalid radius={r}")
            cos_angle = math.cos(cone.angle)
            z = max(self.world_offset_z, cz - r)
            z_end = min(self.world_offset_z + self.world_height(), cz + r)
            x_start = max(self.world_offset_x, cx - r)
            x_end = min(self.world_offset_x + self.world_width(), cx + r)
            while z <= z_end:
                x = x_start
                while x <= x_end:
                    if (x - cx) ** 2 + (z - cz) ** 2 <= r * r:
                        ex, ez = x - cx, z - cz
                        elen = math.hypot(ex, ez)
                        if elen > 0:
                            ex, ez = ex / elen, ez / elen
                        if ex * dx + ez * dz >= cos_angle:
                            self._add_sample(result, cx, cz, x, z)
                    x += step_x
                z += step_z
            result[self.get_channel_id(SpatialInfo(cx, 0, cz))] = 0

        return result

    def _add_sample(self, result: dict, cx: float, cz: float, x: float, z: float) -> None:
        try:
            ch_id = self.get_channel_id(SpatialInfo(x, 0, z))
        except ValueError:
            return
        result[ch_id] = int(math.ceil(_dist_2d(cx, cz, x, z) / self.grid_size()))

    # ---- regions / adjacency --------------------------------------------

    def _server_grid_cols(self) -> int:
        return -(-self.grid_cols // self.server_cols)  # ceil div

    def _server_grid_rows(self) -> int:
        return -(-self.grid_rows // self.server_rows)

    def get_regions(self) -> list[spatial_pb2.SpatialRegion]:
        """One region per LIVE LEAF cell (ref: spatial.go:319-356);
        identical to the legacy base-grid sweep when no splits are
        active (leaves come back in base row-major order)."""
        sgc, sgr = self._server_grid_cols(), self._server_grid_rows()
        tree = self.tree
        regions = []
        if tree is not None:
            for leaf in tree.leaves():
                x0, z0, x1, z1 = tree.rect(leaf)
                regions.append(
                    spatial_pb2.SpatialRegion(
                        min=spatial_pb2.SpatialInfo(x=x0, y=MIN_Y, z=z0),
                        max=spatial_pb2.SpatialInfo(x=x1, y=MAX_Y, z=z1),
                        channelId=leaf,
                        serverIndex=tree.server_index_of(
                            leaf, sgc, sgr, self.server_cols
                        ),
                    )
                )
            return regions
        for y in range(self.grid_rows):
            for x in range(self.grid_cols):
                index = x + y * self.grid_cols
                regions.append(
                    spatial_pb2.SpatialRegion(
                        min=spatial_pb2.SpatialInfo(
                            x=self.world_offset_x + self.grid_width * x,
                            y=MIN_Y,
                            z=self.world_offset_z + self.grid_height * y,
                        ),
                        max=spatial_pb2.SpatialInfo(
                            x=self.world_offset_x + self.grid_width * (x + 1),
                            y=MAX_Y,
                            z=self.world_offset_z + self.grid_height * (y + 1),
                        ),
                        channelId=global_settings.spatial_channel_id_start + index,
                        serverIndex=(x // sgc) + (y // sgr) * self.server_cols,
                    )
                )
        return regions

    def server_index_of_cell(self, spatial_channel_id: int) -> int:
        """The spatial-server index whose authority block contains the
        cell — the same geometric mapping get_regions stamps into
        ``SpatialRegion.serverIndex``. Child cells inherit their base
        cell's server (a split never moves authority across servers by
        itself). The shard directory (federation/directory.py) resolves
        cell->gateway through this. Raises ValueError outside the
        geometry's id space."""
        sgc, sgr = self._server_grid_cols(), self._server_grid_rows()
        tree = self.tree
        if tree is not None:
            try:
                return tree.server_index_of(
                    spatial_channel_id, sgc, sgr, self.server_cols
                )
            except ValueError:
                raise ValueError(
                    f"channel {spatial_channel_id} outside the grid"
                )
        index = spatial_channel_id - global_settings.spatial_channel_id_start
        if index < 0 or index >= self.grid_cols * self.grid_rows:
            raise ValueError(f"channel {spatial_channel_id} outside the grid")
        gx, gy = index % self.grid_cols, index // self.grid_cols
        return (gx // sgc) + (gy // sgr) * self.server_cols

    def get_adjacent_channels(self, spatial_channel_id: int) -> list[int]:
        """Live leaves within one BASE cell of the given cell, minus
        itself — exactly the legacy 3x3 neighborhood when no splits are
        active (ref: spatial.go:358-381)."""
        tree = self.tree
        if tree is not None:
            return tree.neighbor_leaves(spatial_channel_id)
        index = spatial_channel_id - global_settings.spatial_channel_id_start
        gx, gy = index % self.grid_cols, index // self.grid_cols
        out = []
        for y in range(gy - 1, gy + 2):
            if y < 0 or y >= self.grid_rows:
                continue
            for x in range(gx - 1, gx + 2):
                if x < 0 or x >= self.grid_cols or (x == gx and y == gy):
                    continue
                out.append(
                    global_settings.spatial_channel_id_start + x + y * self.grid_cols
                )
        return out

    # ---- server lifecycle ------------------------------------------------

    def _init_server_connections(self) -> None:
        if not self.server_connections:
            self.server_connections = [None] * (self.server_cols * self.server_rows)

    def _allowed_server_indices(self) -> list[int]:
        """Server indices THIS gateway may allocate: all of them in a
        self-contained world; only the shard directory's local block
        assignment in a federated one (remote blocks' cells live on
        other gateways and are never created here — doc/federation.md)."""
        n = self.server_cols * self.server_rows
        if _shard_directory.active:
            return [i for i in _shard_directory.local_server_indices()
                    if i < n]
        return list(range(n))

    def _next_server_index(self) -> int:
        for i in self._allowed_server_indices():
            conn = self.server_connections[i]
            if conn is None or conn.is_closing():
                return i
        return len(self.server_connections)

    def create_channels(self, ctx) -> list:
        """Allocate one server's authority block of spatial channels
        (ref: spatial.go:387-479)."""
        from ..core.channel import create_channel_with_id
        from ..core.channel import get_global_channel
        from ..core.data import unwrap_update_any
        from ..core.message import MessageContext

        self._init_server_connections()
        server_index = self._next_server_index()
        n_servers = self.server_cols * self.server_rows
        if server_index >= n_servers:
            raise RuntimeError(
                f"all {self.grid_cols * self.grid_rows} grids are already "
                f"allocated to {n_servers} servers"
            )
        msg = ctx.msg
        if not isinstance(msg, control_pb2.CreateChannelMessage):
            raise TypeError("ctx.msg is not a CreateChannelMessage")

        sgc, sgr = self._server_grid_cols(), self._server_grid_rows()
        sx, sy = server_index % self.server_cols, server_index // self.server_cols
        channel_ids = []
        for y in range(sgr):
            for x in range(sgc):
                base = self.base_cell_id(sx * sgc + x, sy * sgr + y)
                # A geometry restored BEFORE the servers registered (WAL
                # replay) may already have this base cell split: the
                # server's block is its live leaves, not the base ids.
                if self.tree is not None:
                    channel_ids.extend(self.tree.leaves_under(base))
                else:
                    channel_ids.append(base)

        from ..core.channel import get_channel

        channels = []
        for channel_id in channel_ids:
            # Boot replay can have restored the leaf channel (with its
            # authoritative data) ahead of the owning server's
            # registration — adopt it instead of re-creating.
            ch = get_channel(channel_id)
            if ch is None or ch.is_removing():
                ch = create_channel_with_id(
                    channel_id, ChannelType.SPATIAL, ctx.connection
                )
                if msg.HasField("data"):
                    ch.init_data(unwrap_update_any(msg.data), msg.mergeOptions)
                else:
                    ch.init_data(None, msg.mergeOptions)
            elif not ch.has_owner():
                ch.set_owner(ctx.connection)
            channels.append(ch)

        self.server_connections[server_index] = ctx.connection
        server_index = self._next_server_index()
        if server_index == n_servers:
            # Everyone (this gateway hosts) is in: wire the interest
            # borders, then tell all the local spatial servers (and the
            # master server) the world is ready. In a federated world the
            # remote shards' slots stay None here — their cells live on
            # other gateways (doc/federation.md).
            for i in range(n_servers):
                if self.server_connections[i] is None:
                    continue
                self._sub_to_adjacent_channels(i, sgc, sgr, msg.subOptions)
            ready = spatial_pb2.SpatialChannelsReadyMessage(
                serverIndex=server_index, serverCount=n_servers
            )
            for conn in self.server_connections:
                if conn is None:
                    continue
                conn.send(
                    MessageContext(
                        msg_type=MessageType.SPATIAL_CHANNELS_READY, msg=ready
                    )
                )
            gch = get_global_channel()
            if gch is not None and gch.get_owner() is not None:
                gch.get_owner().send(
                    MessageContext(
                        msg_type=MessageType.SPATIAL_CHANNELS_READY, msg=ready
                    )
                )
        return channels

    def _sub_to_adjacent_channels(
        self, server_index: int, sgc: int, sgr: int, sub_options
    ) -> None:
        """Subscribe a server to the interest border around its authority
        block (ref: spatial.go:481-590)."""
        if self.server_interest_border_size == 0:
            return
        from ..core.channel import get_channel
        from ..core.subscription import subscribe_to_channel
        from ..core.subscription_messages import send_subscribed

        conn = self.server_connections[server_index]
        sx, sy = server_index % self.server_cols, server_index // self.server_cols
        border = self.server_interest_border_size

        def sub_cell(grid_x_units: float, grid_z_units: float) -> None:
            base = self.base_cell_id(int(grid_x_units), int(grid_z_units))
            # Border interest covers every live leaf under the base
            # cell — a split border cell contributes all its children.
            leaves = (
                self.tree.leaves_under(base)
                if self.tree is not None else [base]
            )
            for channel_id in leaves:
                ch = get_channel(channel_id)
                if ch is None:
                    if not _shard_directory.is_local_cell(channel_id):
                        # Border cell in a remote shard: it has no local
                        # channel to subscribe to. Cross-gateway interest
                        # arrives as handover/redirect traffic instead.
                        continue
                    raise RuntimeError(
                        f"border channel {channel_id} doesn't exist"
                    )
                cs, should_send = subscribe_to_channel(conn, ch, sub_options)
                if should_send:
                    send_subscribed(conn, ch, conn, 0, cs.options)

        if sx > 0:  # cells to the left of the block
            for y in range(sgr):
                for x in range(1, border + 1):
                    sub_cell(sx * sgc - x, sy * sgr + y)
        if sx < self.server_cols - 1:  # right
            for y in range(sgr):
                for x in range(border):
                    sub_cell((sx + 1) * sgc + x, sy * sgr + y)
        if sy > 0:  # below
            for y in range(1, border + 1):
                for x in range(sgc):
                    sub_cell(sx * sgc + x, sy * sgr - y)
        if sy < self.server_rows - 1:  # above
            for y in range(border):
                for x in range(sgc):
                    sub_cell(sx * sgc + x, (sy + 1) * sgr + y)

    def tick(self) -> None:
        """Reap closed server connections (ref: spatial.go:884-893), then
        run the load-balancer update (doc/balancer.md) and the adaptive
        partitioning governor (doc/partitioning.md) — all inside the
        GLOBAL channel tick, the single-writer context every channel
        mutation here requires."""
        self._init_server_connections()
        for i, conn in enumerate(self.server_connections):
            if conn is not None and conn.is_closing():
                self.server_connections[i] = None
                logger.info("reset spatial server connection %d", i)
        _balancer.update(self)
        _partition.update(self)

    # ---- live geometry (doc/partitioning.md) -----------------------------

    @property
    def geometry_epoch(self) -> int:
        return self.tree.epoch if self.tree is not None else 0

    def geometry_splits(self) -> frozenset:
        return self.tree.splits if self.tree is not None else frozenset()

    def apply_geometry(self, epoch: int, splits) -> None:
        """Replace the live cell geometry wholesale. The ONLY mutation
        path — used by the partition plane's commit/abort, trunk
        geometry sync (federation/control.py) and WAL replay. Validates
        the split set, bumps the epoch gauge, refreshes the per-leaf
        depth gauges and invokes the device-rebuild hook."""
        if self.tree is None:
            raise RuntimeError("geometry applied before load_config")
        from ..core import metrics

        old_leaves = set(self.tree.leaves())
        self.tree.apply(epoch, splits)
        metrics.partition_geometry_epoch.set(epoch)
        new_leaves = set(self.tree.leaves())
        for cell in old_leaves - new_leaves:
            metrics.spatial_cell_depth.labels(cell=str(cell)).set(0)
        for cell in new_leaves:
            metrics.spatial_cell_depth.labels(cell=str(cell)).set(
                self.tree.depth_of(cell)
            )
        self.on_geometry_changed()

    def on_geometry_changed(self) -> None:
        """Hook for the device plane (tpu_controller overrides): rebuild
        interest masks and cell-id arrays for the new geometry epoch.
        The host-semantics controller needs nothing — every lookup
        already consults the live tree."""

    # ---- handover --------------------------------------------------------

    def notify(
        self,
        old_info: SpatialInfo,
        new_info: SpatialInfo,
        handover_data_provider: Callable[[int, int], Optional[int]],
    ) -> None:
        """Cross-cell entity migration (ref: spatial.go:612-858).

        ``handover_data_provider(src, dst)`` returns the id of the entity
        whose movement triggered the notification (the reference passes an
        out-pointer; we return it).
        """
        try:
            src_channel_id = self.get_channel_id(old_info)
            dst_channel_id = self.get_channel_id(new_info)
        except ValueError as e:
            logger.error("failed to compute handover channel ids: %s", e)
            return
        if src_channel_id == dst_channel_id:
            return
        # Position-derived src vs the authoritative placement ledger:
        # an entity applied here by a trunked handover / adoption
        # bootstrap has data in a cell its position history knows
        # nothing about — orchestrating from the position's src would
        # leave that data behind as a stale duplicate. Same discipline
        # as the TPU tick path (tpu_controller.tick): the in-flight
        # journal outranks the committed ledger.
        from ..core.failover import journal as _jrn

        eid = handover_data_provider(-1, -1)
        if eid is not None:
            if _jrn.remote_in_flight(eid):
                # Mid cross-gateway flight: commit removes the entity
                # here; abort restores and re-offers it. Orchestrating
                # this hop now would duplicate the data.
                return
            known = _jrn.pending_dst(eid)
            if known is None:
                known = self._data_cell.get(eid)
            if known is not None and known != src_channel_id:
                if known == dst_channel_id:
                    return  # stale re-detection: the data already moved
                # Chained hop: per-channel FIFO puts this remove after
                # the pending add on `known`.
                src_channel_id = known
        frozen = _balancer.frozen_cells
        if frozen or _balancer._frozen_crossings:
            # A live migration has a cell frozen: park crossings that
            # touch it (one pending move per entity; chains collapse) —
            # they replay through the batched orchestration on
            # unfreeze. An entity with an ALREADY-parked crossing keeps
            # chaining into it even off-freeze: its true origin is the
            # parked entry's. Checked BEFORE the remote-dst branch: a
            # federated handover out of a frozen src cell would mutate
            # the cell mid-migration (the packed-state bootstrap could
            # ship an entity the trunk just moved).
            if eid is not None and (
                src_channel_id in frozen
                or dst_channel_id in frozen
                or eid in _balancer._frozen_crossings
            ):
                _balancer.defer_crossing(
                    eid, old_info, new_info, handover_data_provider
                )
                return
        if not _shard_directory.is_local_cell(dst_channel_id):
            # The destination cell lives on another gateway: this
            # crossing is a cross-gateway handover — the transactional
            # journal extended over the trunk (federation/plane.py,
            # doc/federation.md). Never orchestrated locally.
            from ..federation.plane import plane as _fed_plane

            _fed_plane.initiate_handover(
                src_channel_id, dst_channel_id, [handover_data_provider]
            )
            return
        self._orchestrate_pair(src_channel_id, dst_channel_id,
                               [handover_data_provider])

    def entity_position(self, entity_id: int):
        """Last known world position of one tracked entity, or None when
        the controller keeps no position cache (host-semantics mode).
        The partition plane uses this to sort residents into child
        quadrants at split commit; with no position the entity
        bootstraps into the child containing the parent's center and
        re-sorts on its next movement."""
        return None

    def _note_entity_data_moved(self, entity_ids, dst_channel_id: int) -> None:
        """Placement-ledger callback: fires only when entity data
        ACTUALLY moved (a skipped orchestration — missing channel,
        locked group — must leave the ledger on the cell the data still
        lives in, or stale re-detections would be mis-suppressed and
        the data stranded). Called from the local orchestration's
        commit hook, the federation apply/restore paths, and the
        global-control adoption bootstrap."""
        for eid in entity_ids:
            self._data_cell[eid] = dst_channel_id
        from ..core.wal import wal as _wal

        if _wal.enabled:
            # Placement flips ride the WAL (doc/persistence.md): boot
            # replay re-seeds the ledger from the restored cell rows,
            # then overlays these so a mid-crossing entity re-baselines
            # to where its data is BOUND, not where a stale row says.
            _wal.log_flip(entity_ids, dst_channel_id)

    def on_cell_rehosted(self, cell_channel_id: int, new_owner) -> None:
        """Failover hook (core/failover.py): the cell's authority moved
        to ``new_owner``. What must stay exact is the placement ledger:
        re-seed a row for every entity actually resident in the cell's
        authoritative data (an entity shed/re-tracked during the outage
        can have lost its row, and a later crossing orchestrated from
        the wrong origin would leave its data duplicated across two
        cells)."""
        from ..core.channel import get_channel

        ch = get_channel(cell_channel_id)
        if ch is None:
            return
        entities = getattr(ch.get_data_message(), "entities", None)
        if entities is None:
            return
        for eid in entities:
            self._data_cell.setdefault(eid, cell_channel_id)

    def notify_crossings(self, crossings) -> None:
        """Batched migration: ``crossings`` is an iterable of
        (old_info, new_info, provider). Crossings sharing a
        (src, dst) channel pair are orchestrated together — one owner-swap
        pass, one remove/add Execute hop per channel, one fan-out message
        per recipient per pair — preserving the reference's per-pair
        ordering (owner swap -> remove/add -> fan-out,
        ref: spatial.go:612-858). The device detects crossings in batch
        (~1.5K per tick at the flagship load); per-crossing orchestration
        measured 87.8us each (11.4K/s, scripts/bench_handover.py) — far
        under the 44.5K/s detection rate, hence this path."""
        groups: dict = {}  # insertion-ordered: first-crossing pair order
        remote_groups: dict = {}  # (src, dst) -> providers, dst on a peer
        frozen = _balancer.frozen_cells
        for old_info, new_info, provider in crossings:
            try:
                s = self.get_channel_id(old_info)
                d = self.get_channel_id(new_info)
            except ValueError as e:
                logger.error("failed to compute handover channel ids: %s", e)
                continue
            if s == d:
                continue
            if frozen or _balancer._frozen_crossings:
                eid = provider(-1, -1)
                if eid is not None and (
                    s in frozen
                    or d in frozen
                    # An entity that ALREADY has a parked crossing must
                    # keep chaining into it even when this hop touches
                    # no frozen cell: its true origin is the parked
                    # entry's — orchestrating this hop now would move
                    # data from the wrong cell and the later replay
                    # would duplicate it.
                    or eid in _balancer._frozen_crossings
                ):
                    # Live migration in flight: park the crossing with
                    # the balancer (chains collapse per entity); it
                    # replays through this very path once the migration
                    # commits or aborts. Outranks the remote-dst branch:
                    # a federated handover out of a frozen src would
                    # mutate the cell mid-migration.
                    _balancer.defer_crossing(eid, old_info, new_info,
                                             provider)
                    continue
            if not _shard_directory.is_local_cell(d):
                # Remote destination: batched cross-gateway handover
                # (one trunk prepare per (src, dst) pair per tick).
                remote_groups.setdefault((s, d), []).append(provider)
                continue
            groups.setdefault((s, d), []).append(provider)
        for (s, d), providers in groups.items():
            self._orchestrate_pair(s, d, providers)
        if remote_groups:
            from ..federation.plane import plane as _fed_plane

            for (s, d), providers in remote_groups.items():
                _fed_plane.initiate_handover(s, d, providers)

    def _orchestrate_pair(
        self, src_channel_id: int, dst_channel_id: int, providers: list
    ) -> None:
        """Owner swap -> data remove/add -> handover fan-out for every
        crossing between one (src, dst) spatial channel pair."""
        from ..core.channel import get_channel
        from ..core.data import reflect_channel_data_message
        from ..core.failover import journal as _journal
        from ..core.message import MessageContext
        from ..core.subscription import subscribe_to_channel
        from ..core.subscription_messages import send_subscribed, send_unsubscribed
        from ..core.types import ChannelDataAccess
        from ..core.subscription import unsubscribe_from_channel

        src_channel = get_channel(src_channel_id)
        dst_channel = get_channel(dst_channel_id)
        if src_channel is None or dst_channel is None:
            logger.error(
                "handover impossible: channel missing (src=%s dst=%s)",
                src_channel_id, dst_channel_id,
            )
            return

        from ..core import metrics

        handover_entities: dict = {}
        contributing = 0
        for provider in providers:
            handover_entity_id = provider(src_channel_id, dst_channel_id)
            if handover_entity_id is None:
                continue
            if _journal.remote_in_flight(handover_entity_id):
                # Mid cross-gateway flight (a shard drain or a trunked
                # crossing): the remote batch already captured the
                # data. Commit removes the entity here; abort restores
                # and re-offers it — orchestrating this local hop now
                # would leave the data in two cells.
                continue
            entity_channel = get_channel(handover_entity_id)
            if entity_channel is None:
                logger.warning(
                    "handover skipped: entity channel %d doesn't exist",
                    handover_entity_id,
                )
                continue
            group = entity_channel.get_handover_entities(handover_entity_id)
            if not group:
                continue  # a member is locked, or nothing to move
            contributing += 1
            handover_entities.update(group)
        if not handover_entities:
            return
        metrics.handover_count.inc(contributing)
        # Per-cell crossing observability + the balancer's crossing-rate
        # signal (doc/balancer.md): one orchestration counts against
        # both ends of the pair.
        metrics.spatial_cell_crossings.labels(
            cell=str(src_channel_id), direction="out"
        ).inc(contributing)
        metrics.spatial_cell_crossings.labels(
            cell=str(dst_channel_id), direction="in"
        ).inc(contributing)
        _balancer.note_crossing(src_channel_id, dst_channel_id, contributing)
        from ..federation.control import control as _global_control

        _global_control.note_crossing(contributing)

        # Step 1: cross-server — swap entity-channel ownership first so the
        # src server's residual updates are ignored (prevents handover loops).
        if not src_channel.is_same_owner(dst_channel):
            for entity_id in handover_entities:
                entity_ch = get_channel(entity_id)
                if entity_ch is None:
                    continue
                owner = src_channel.get_owner()
                if (
                    owner is not None
                    and not owner.is_closing()
                    and not owner.has_interest_in(dst_channel_id)
                ):
                    try:
                        unsubscribe_from_channel(owner, entity_ch)
                        send_unsubscribed(owner, entity_ch, None, 0)
                    except KeyError:
                        pass
                entity_ch.set_owner(dst_channel.get_owner())

        # Step 2: move the entities between the spatial channels' data,
        # each inside its own channel's execution context — wrapped in a
        # transactional journal (core/failover.py): prepare here, the
        # remove marks the src hop done, the dst's add COMMITS. A crash
        # between the hops resolves deterministically to exactly one
        # owning cell (the failover pass aborts records whose dst can
        # never run and re-adds the data to src through the same FIFO
        # queue), and the authoritative placement ledger only flips on
        # commit — never on an optimistic queue.
        from ..core.failover import journal as _journal

        records = _journal.prepare(
            handover_entities, src_channel_id, dst_channel_id
        )
        moved_hook = getattr(self, "_note_entity_data_moved", None)

        def _remove(ch):
            data_msg = ch.get_data_message()
            remover = getattr(data_msg, "remove_entity", None)
            if remover is None:
                ch.logger.warning("spatial data can't remove entities")
                return
            for entity_id in handover_entities:
                remover(entity_id)
            _journal.note_removed(records)

        def _add(ch):
            data_msg = ch.get_data_message()
            adder = getattr(data_msg, "add_entity", None)
            if adder is None:
                ch.logger.warning("spatial data can't add entities")
                for rec in records:
                    _journal.abort(rec)
                return
            for entity_id, entity_data in handover_entities.items():
                if entity_data is not None:
                    adder(entity_id, entity_data)
            flips = _journal.commit(records)
            # Placement hook: the move is now REAL (the add ran in the
            # dst tick). Controllers keeping an authoritative placement
            # ledger (the TPU controller's _data_cell, which
            # de-duplicates stale engine re-detections) flip it here —
            # never on a skipped orchestration or an in-flight one, and
            # only for entities whose flip the journal granted (commits
            # land in channel-tick order; a chained hop may have
            # committed first).
            if moved_hook is not None and flips:
                moved_hook(flips, dst_channel_id)

        src_channel.execute(_remove)
        dst_channel.execute(_add)

        # Step 3: identifier-only handover payload for src-side connections.
        spatial_data_msg = reflect_channel_data_message(ChannelType.SPATIAL)
        if spatial_data_msg is None:
            logger.error("no SPATIAL channel data type registered for handover")
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
            else:
                logger.warning("entity %d data has no merge_to()", entity_id)

        context_conn_id = src_channel.latest_data_update_conn_id
        base_msg = spatial_pb2.ChannelDataHandoverMessage(
            srcChannelId=src_channel_id,
            dstChannelId=dst_channel_id,
            contextConnId=context_conn_id,
            data=pack_any(spatial_data_msg),
        )

        src_conns = src_channel.get_all_connections()
        dst_conns = dst_channel.get_all_connections()
        # Overload L2+: only REDUNDANT handover payloads are shed — dst
        # clients already subscribed to every moved entity (their state
        # keeps flowing through the entity channels). The src-side
        # identifier-only message is load-bearing (it is the only signal
        # that the entity LEFT the cell; entity removal cannot ride a
        # map-merge delta) and, post-batching, one shared encode — it is
        # never withheld.
        defer_fanout = _governor.defer_handover_fanout()

        # Step 4-1: src-only connections get the identifier-only payload.
        # ONE context, encoded once, shared by every recipient (the
        # queued sender consumes fields into a tuple immediately) — the
        # per-recipient rebuild+re-encode was the dominant share of the
        # 21.8us/handover host cost at r5 load.
        src_only = src_conns - dst_conns
        if src_only:
            shared = MessageContext(
                msg_type=MessageType.CHANNEL_DATA_HANDOVER,
                msg=base_msg,
                channel_id=dst_channel_id,
            )
            shared.ensure_raw_body()
            for conn in src_only:
                conn.send(shared)

        # Step 4-2: dst connections are auto-subscribed to the entity
        # channels (WRITE for the new owner) and receive full entity data
        # when newly subscribed.
        # Hoisted: subscribe_to_channel only reads the options (MergeFrom
        # into the per-sub copy), so the two access variants can be shared
        # across every (conn x entity) subscription in the pair.
        _write_opts = control_pb2.ChannelSubscriptionOptions(
            skipSelfUpdateFanOut=True,
            # Entity data rides in the handover message itself.
            skipFirstFanOut=True,
            dataAccess=ChannelDataAccess.WRITE_ACCESS,
        )
        _read_opts = control_pb2.ChannelSubscriptionOptions(
            skipSelfUpdateFanOut=True,
            skipFirstFanOut=True,
            dataAccess=ChannelDataAccess.READ_ACCESS,
        )
        # Entity channel + merger resolved once per pair, not per conn.
        _targets = []
        for entity_id, entity_data in handover_entities.items():
            entity_ch = get_channel(entity_id)
            if entity_ch is None or entity_data is None:
                continue
            _targets.append(
                (entity_ch, getattr(entity_data, "merge_to", None))
            )
        # Grouped per connection: the subscription pass runs first (state
        # must stay exact even under overload deferral), then exactly one
        # handover message per conn — and conns whose subscription state
        # didn't change all carry the identical payload, so it is built
        # and encoded once and the context shared across them.
        dst_owner = dst_channel.get_owner()
        shared_ctx = None  # the no-new-subscription payload, lazily built
        for conn in dst_conns:
            if conn is None or conn.is_closing():
                # A mid-disconnect conn would subscribe to nothing and
                # build an EMPTY payload — which must never become the
                # cached shared_ctx served to healthy recipients.
                continue
            any_new = False
            merges = []
            for entity_ch, merger in _targets:
                sub_options = (
                    _write_opts if conn is entity_ch.get_owner() else _read_opts
                )
                cs, should_send = subscribe_to_channel(conn, entity_ch, sub_options)
                if cs is None:
                    continue
                if should_send:
                    send_subscribed(conn, entity_ch, conn, 0, cs.options)
                    any_new = True
                merges.append((merger, should_send))
            if (
                defer_fanout
                and not any_new
                and conn is not dst_owner
                and conn.connection_type == ConnectionType.CLIENT
            ):
                # Redundant for this recipient: it was already subscribed
                # to every moved entity (no new sub -> no full state in
                # the payload it would miss), and the entity channels'
                # own fan-out keeps carrying the state. A conn with ANY
                # new subscription still gets the message — it carries
                # that entity's full state (skipFirstFanOut skipped the
                # usual full-state send on purpose).
                _governor.count_shed("handover_fanout")
                continue
            if not any_new and shared_ctx is not None:
                conn.send(shared_ctx)
                continue
            handover_data_msg = type(spatial_data_msg)()
            initializer = getattr(handover_data_msg, "init_data", None)
            if callable(initializer):
                initializer()
            for merger, should_send in merges:
                if callable(merger):
                    # Full state for new subscribers.
                    merger(handover_data_msg, should_send)
            ctx_out = MessageContext(
                msg_type=MessageType.CHANNEL_DATA_HANDOVER,
                msg=spatial_pb2.ChannelDataHandoverMessage(
                    srcChannelId=src_channel_id,
                    dstChannelId=dst_channel_id,
                    contextConnId=context_conn_id,
                    data=pack_any(handover_data_msg),
                ),
                channel_id=dst_channel_id,
            )
            ctx_out.ensure_raw_body()
            # Cache only a payload that covered every entity in the pair
            # (a partial build — e.g. a subscription refused mid-loop —
            # must not be replayed to other recipients).
            if not any_new and len(merges) == len(_targets):
                shared_ctx = ctx_out
            conn.send(ctx_out)


register_spatial_controller_type(
    "Static2DSpatialController", StaticGrid2DSpatialController
)
register_spatial_controller_type(
    "StaticGrid2DSpatialController", StaticGrid2DSpatialController
)
