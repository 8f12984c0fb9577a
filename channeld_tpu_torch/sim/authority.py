"""Sim authority: the population's internal server peer (doc/simulation.md).

Agents are OWNED like any server-spawned entity: the plane registers one
internal SERVER connection (a real :class:`~channeld_tpu.core.connection.
Connection` over a null transport — no socket, no reactor) and gives up
to ``sim_channel_agents`` agents real entity channels owned by it, added
to their cell channel's entity table through the ordinary Execute path.
Census commits then flow through ``ChannelData.on_update`` exactly like
a remote server's movement updates — the handover trigger, fan-out and
placement ledger all see agents through the same seam as humans.

Agents beyond the cap are engine-only: device-tracked entities with no
channel data anywhere, so their crossings need no orchestration (the
controller skips them). That mode exists for engine-direct benches at
100K+ agents; a live channel world should keep ``sim_agents`` at or
under ``sim_channel_agents``.

Threading (doc/concurrency.md): all methods run on the GLOBAL tick loop.
"""

from __future__ import annotations

from typing import Optional

from ..core.settings import global_settings
from ..utils.logger import get_logger

logger = get_logger("sim.authority")


class _NullTransport:
    """Byte sink for the internal connection: frames fanned out TO the
    authority (its own subscriptions echo back) are counted and
    dropped — there is no remote process to deliver them to."""

    def __init__(self):
        self.bytes_dropped = 0

    def write(self, data: bytes) -> None:
        self.bytes_dropped += len(data)

    def close(self) -> None:
        pass

    def remote_addr(self):
        return None  # in-process: no addr, no ban check, no accounting


class SimAuthority:
    """Owns the agents' entity channels via an internal server conn."""

    def __init__(self, controller):
        self.controller = controller
        self.conn = None
        self.transport: Optional[_NullTransport] = None
        self._backed: set[int] = set()    # agents with live entity channels
        self._pending: list[tuple[int, float, float]] = []  # awaiting attach
        self.ledgers: dict[str, int] = {}

    # ---- internal connection --------------------------------------------

    def ensure_connection(self):
        """The internal peer, created on first use: a real SERVER-type
        connection authenticated immediately (the unauthenticated reaper
        must never harvest it) with no socket behind it."""
        if self.conn is not None and not self.conn.is_closing():
            return self.conn
        from ..core.connection import add_connection
        from ..core.types import ConnectionType

        self.transport = _NullTransport()
        conn = add_connection(self.transport, ConnectionType.SERVER)
        conn.on_authenticated("sim-authority")
        self.conn = conn
        self._count("connections", 1)
        logger.info("sim authority connected as server conn %d", conn.id)
        return conn

    # ---- population attach ----------------------------------------------

    def adopt(self, ids) -> None:
        """Queue agents for channel attachment (bounded per tick by
        ``sim_attach_per_tick``; retried while the world boots). Agents
        past the ``sim_channel_agents`` cap stay engine-only."""
        from ..core.channel import get_channel

        ctl = self.controller
        cap = int(global_settings.sim_channel_agents)
        for eid in ids:
            eid = int(eid)
            if get_channel(eid) is not None:
                # WAL/snapshot restore already rebuilt the channel.
                self._backed.add(eid)
                continue
            if len(self._backed) + len(self._pending) >= cap:
                self._count("engine_only", 1)
                continue
            info = ctl._last_positions.get(eid)
            if info is None:
                continue
            self._pending.append((eid, float(info.x), float(info.z)))

    def pump(self) -> None:
        """One bounded attach pass (called from the plane's pre_step):
        attach pending agents whose cell channel exists; cells still
        booting go back on the queue."""
        if not self._pending:
            return
        budget = max(1, int(global_settings.sim_attach_per_tick))
        retry: list[tuple[int, float, float]] = []
        taken = self._pending[:budget]
        rest = self._pending[budget:]
        for eid, x, z in taken:
            done = self._attach(eid, x, z)
            if done is None:
                retry.append((eid, x, z))
        self._pending = retry + rest

    def _attach(self, eid: int, x: float, z: float) -> Optional[bool]:
        """Create the agent's entity channel + cell-table row through the
        ordinary channel path. True = attached, False = dropped (outside
        the world), None = retry later (cell channel not up yet)."""
        from ..core.channel import create_entity_channel, get_channel
        from ..core.subscription import subscribe_to_channel
        from ..models import sim_pb2
        from ..spatial.controller import SpatialInfo

        ctl = self.controller
        try:
            cell_id = ctl.get_channel_id(SpatialInfo(x, 0.0, z))
        except ValueError:
            self._count("attach_dropped", 1)
            return False
        cell_ch = get_channel(cell_id)
        if cell_ch is None or cell_ch.is_removing():
            return None
        if get_channel(eid) is not None:
            self._backed.add(eid)
            return True
        conn = self.ensure_connection()
        try:
            ch = create_entity_channel(eid, conn)
        except Exception as e:  # ChannelFullError / id races: engine-only
            logger.warning("sim agent %d channel attach failed: %s", eid, e)
            self._count("attach_dropped", 1)
            return False
        d = sim_pb2.SimEntityChannelData()
        d.state.entityId = eid
        d.state.transform.position.x = x
        d.state.transform.position.z = z
        ch.init_data(d, None)
        ch.spatial_notifier = ctl
        subscribe_to_channel(conn, ch, None)
        cell_ch.execute(
            lambda c, e=eid, dd=d: c.get_data_message().add_entity(e, dd)
        )
        self._backed.add(eid)
        self._count("attached", 1)
        return True

    # ---- census commit ---------------------------------------------------

    def is_backed(self, eid: int) -> bool:
        return eid in self._backed

    def pending_count(self) -> int:
        return len(self._pending)

    def commit(self, ids, positions) -> int:
        """Commit one census batch through the ordinary channel path:
        each channel-backed agent's entity channel merges a position
        update via ``on_update`` — the same seam a remote server's
        movement updates flow through, so handover triggers, fan-out and
        the placement ledger behave identically for agents and humans.
        ``positions`` is a host list of [x, y, z] rows (the plane
        converts the census before calling). Returns the number of
        updates committed."""
        from ..core.channel import get_channel
        from ..models import sim_pb2

        if not self._backed:
            return 0
        ctl = self.controller
        n = 0
        for i, eid in enumerate(ids):
            eid = int(eid)
            if eid not in self._backed:
                continue
            ch = get_channel(eid)
            if ch is None or ch.is_removing():
                self._backed.discard(eid)
                continue
            upd = sim_pb2.SimEntityChannelData()
            upd.state.entityId = eid
            upd.state.transform.position.x = positions[i][0]
            upd.state.transform.position.z = positions[i][2]

            def _apply(c, u=upd):
                owner = c.get_owner()
                c.data.on_update(
                    u, c.get_time(),
                    owner.id if owner is not None else 0, ctl,
                )

            ch.execute(_apply)
            n += 1
        self._count("commits", 1)
        self._count("updates", n)
        return n

    # ---- accounting ------------------------------------------------------

    def _count(self, key: str, n: int) -> None:
        self.ledgers[key] = self.ledgers.get(key, 0) + n

    def report(self) -> dict:
        return {
            "ledgers": dict(self.ledgers),
            "channel_backed": len(self._backed),
            "pending_attach": len(self._pending),
            "bytes_dropped": (
                self.transport.bytes_dropped if self.transport else 0
            ),
        }
