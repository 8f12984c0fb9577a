"""Trunk links: authenticated gateway<->gateway connections.

Reuses the client/server wire framing (protocol/framing.py: the 5-byte
tag + a serialized ``chtpu.Packet``) so trunk traffic is inspectable
with the same tooling, but trunks are a separate plane: they never
share a ``Connection`` object, never enter channel routing, and carry
only the TRUNK_* message types (protocol/control.proto).

Lifecycle per peer pair: both gateways listen on their configured trunk
address; the lexicographically smaller gateway id dials (one TCP
connection per pair, no simultaneous-open glare). The first frame in
each direction is a ``TrunkHelloMessage`` carrying the gateway id and
the shared secret — a mismatch closes the socket. After the handshake
both sides heartbeat every ``federation_heartbeat_ms``; a silent trunk
past ``federation_trunk_timeout_ms`` is declared down, the plane aborts
its in-flight handovers toward that peer, and the dialing side
reconnects with exponential backoff (:func:`backoff_schedule`,
deterministic and unit-tested).

Chaos points on egress (doc/chaos.md): ``trunk.egress_drop`` silently
drops an outbound frame (lossy inter-gateway link — heartbeats and the
handover timeout absorb it); ``trunk.sever`` aborts the socket before
the write (link partition — the reconnect/abort/reconcile path).
"""

from __future__ import annotations

import asyncio
import random
import time
import zlib
from typing import Awaitable, Callable, Optional

from ..chaos.injector import chaos as _chaos
from ..core.settings import global_settings
from ..core.tracing import recorder as _trace
from ..core.types import MessageType
from ..protocol import control_pb2, spatial_pb2, wire_pb2
from ..protocol.framing import FrameDecoder, FramingError, encode_packet
from ..utils.logger import get_logger

logger = get_logger("federation.trunk")

# Trunk wire dispatch: msgType -> protobuf class. Anything else arriving
# on a trunk is a protocol violation and closes the link.
TRUNK_MESSAGES = {
    MessageType.TRUNK_HELLO: control_pb2.TrunkHelloMessage,
    MessageType.TRUNK_HEARTBEAT: control_pb2.TrunkHeartbeatMessage,
    MessageType.TRUNK_HANDOVER_PREPARE: control_pb2.TrunkHandoverPrepareMessage,
    MessageType.TRUNK_HANDOVER_ACK: control_pb2.TrunkHandoverAckMessage,
    MessageType.TRUNK_ABORT_NOTICE: control_pb2.TrunkAbortNoticeMessage,
    MessageType.TRUNK_STAGE_REDIRECT: control_pb2.TrunkStageRedirectMessage,
    MessageType.TRUNK_STAGE_ACK: control_pb2.TrunkStageAckMessage,
    MessageType.TRUNK_DIRECTORY_UPDATE: control_pb2.TrunkDirectoryUpdateMessage,
    # Global control plane (federation/control.py; doc/global_control.md).
    MessageType.TRUNK_LOAD_REPORT: control_pb2.TrunkLoadReportMessage,
    MessageType.TRUNK_SHARD_EPOCH: control_pb2.TrunkShardEpochMessage,
    MessageType.TRUNK_SHARD_MIGRATE: control_pb2.TrunkShardMigrateMessage,
    MessageType.TRUNK_MIGRATE_STATUS: control_pb2.TrunkMigrateStatusMessage,
    MessageType.TRUNK_GATEWAY_DEAD: control_pb2.TrunkGatewayDeadMessage,
    MessageType.TRUNK_ADOPT_DONE: control_pb2.TrunkAdoptDoneMessage,
    MessageType.TRUNK_ADOPT_QUERY: control_pb2.TrunkAdoptQueryMessage,
    MessageType.TRUNK_ADOPT_CLAIMS: control_pb2.TrunkAdoptClaimsMessage,
    # Durable persistence plane (core/wal.py; doc/persistence.md).
    MessageType.TRUNK_RESURRECT_HELLO: control_pb2.TrunkResurrectHelloMessage,
    # Adaptive partitioning geometry sync (spatial/partition.py;
    # doc/partitioning.md) — the same message engine SDKs receive,
    # reused peer-to-peer for leader anti-entropy.
    MessageType.CELL_GEOMETRY_UPDATE: spatial_pb2.CellGeometryUpdateMessage,
}


def backoff_schedule(
    attempt: int, base_ms: int, max_ms: int, peer: str = ""
) -> float:
    """Reconnect delay in seconds for the Nth consecutive failed dial
    (attempt 0 = first retry): ``base * 2^attempt`` capped at ``max``,
    with deterministic +-20% jitter derived from (peer, attempt) so a
    fleet restarting together doesn't dial in lockstep — and so tests
    can pin exact values."""
    delay_ms = min(base_ms * (2 ** min(attempt, 16)), max_ms)
    seed = zlib.crc32(f"{peer}:{attempt}".encode())
    jitter = (random.Random(seed).random() * 0.4) - 0.2
    return delay_ms * (1.0 + jitter) / 1000.0


def _frame(msg_type: int, msg) -> bytes:
    return encode_packet(wire_pb2.Packet(messages=[wire_pb2.MessagePack(
        channelId=0, msgType=int(msg_type), msgBody=msg.SerializeToString(),
    )]))


class TrunkLink:
    """One live, authenticated trunk connection to a peer gateway."""

    def __init__(
        self,
        peer_id: str,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        on_message: Callable[[str, int, object], None],
        on_down: Callable[[str, "TrunkLink"], None],
        decoder: Optional[FrameDecoder] = None,
        pending: Optional[list] = None,
    ):
        self.peer_id = peer_id
        self._reader = reader
        self._writer = writer
        self._on_message = on_message
        self._on_down = on_down
        # The HANDSHAKE decoder carries over: frames coalesced into the
        # same TCP read as the peer's hello (e.g. abort notices the
        # peer flushes the instant its side comes up) must not be lost,
        # nor may the stream desync on the decoder's buffered tail.
        self._decoder = decoder if decoder is not None else FrameDecoder()
        self._pending = list(pending or [])
        self._tasks: list[asyncio.Task] = []
        self._last_rx = time.monotonic()
        self.alive = True
        self.established_at = time.monotonic()
        # EWMA of the heartbeat RTT, exported in the control plane's
        # load vector (doc/global_control.md); 0.0 until the first ack.
        self.rtt_ms = 0.0

    def start(self) -> None:
        for mp in self._pending:
            self._dispatch(mp)
        self._pending = []
        self._tasks = [
            asyncio.ensure_future(self._read_loop()),
            asyncio.ensure_future(self._heartbeat_loop()),
        ]

    # ---- egress ----------------------------------------------------------

    def send(self, msg_type: int, msg) -> bool:
        """Write one trunk frame; False when the link is (or just went)
        dead. Chaos egress points fire here — a severed link takes the
        normal down path (abort in-flight, reconnect, reconcile)."""
        if not self.alive:
            return False
        if _chaos.armed:
            if _chaos.fire("trunk.sever"):
                logger.warning(
                    "chaos: trunk to %s severed on egress", self.peer_id
                )
                self._go_down("chaos sever")
                return False
            if _chaos.fire("trunk.egress_drop"):
                return True  # silently lost on the wire
        try:
            self._writer.write(_frame(msg_type, msg))
        except (ConnectionError, OSError, RuntimeError):
            self._go_down("write failed")
            return False
        from ..core import metrics

        metrics.trunk_msgs.labels(direction="out").inc()
        return True

    # ---- ingress ---------------------------------------------------------

    def _dispatch(self, mp) -> bool:
        """Decode + route one MessagePack; False closes the link."""
        from ..core import metrics

        cls = TRUNK_MESSAGES.get(mp.msgType)
        if cls is None:
            logger.error(
                "non-trunk msgType %d from %s; closing",
                mp.msgType, self.peer_id,
            )
            self._go_down("protocol violation")
            return False
        msg = cls()
        try:
            msg.ParseFromString(mp.msgBody)
        except Exception:
            logger.error(
                "undecodable trunk msgType %d from %s",
                mp.msgType, self.peer_id,
            )
            return True
        metrics.trunk_msgs.labels(direction="in").inc()
        if mp.msgType == MessageType.TRUNK_HEARTBEAT:
            self._on_heartbeat(msg)
        else:
            self._on_message(self.peer_id, mp.msgType, msg)
        return True

    async def _read_loop(self) -> None:
        while self.alive:
            try:
                data = await self._reader.read(65536)
            except (ConnectionError, OSError):
                data = b""
            except asyncio.CancelledError:
                return
            if not data:
                self._go_down("peer closed")
                return
            self._last_rx = time.monotonic()
            trunk_start = _trace.now()
            try:
                packets = self._decoder.decode_packets(data)
            except FramingError as e:
                logger.error("trunk %s framing error: %s", self.peer_id, e)
                self._go_down("framing error")
                return
            dispatched = False
            for packet in packets:
                for mp in packet.messages:
                    dispatched = True
                    if not self._dispatch(mp):
                        return
            if dispatched:
                # Decode + dispatch for one trunk read — the federation
                # plane's share of the tick timeline (heartbeat-only
                # reads included: they ARE trunk I/O cost).
                _trace.stage("trunk", trunk_start)

    def _on_heartbeat(self, msg) -> None:
        from ..core import metrics

        if msg.goodbye:
            # Graceful-shutdown farewell: the peer is draining on
            # purpose. Surface it to the plane (the control-plane
            # leader fast-tracks the death declaration) and take the
            # link down NOW — in-flight handovers toward the dying
            # peer abort deterministically through the ordinary
            # trunk-down path instead of churning until timeout.
            self._on_message(self.peer_id, int(MessageType.TRUNK_HEARTBEAT),
                             msg)
            self._go_down("peer goodbye (graceful shutdown)")
            return
        if msg.ack:
            rtt_ms = time.monotonic() * 1000.0 - msg.sentAtMs
            if 0 <= rtt_ms < 60_000:
                metrics.trunk_rtt_ms.observe(rtt_ms)
                from ..core.slo import slo as _slo

                if _slo.enabled:
                    # The trunk_rtt SLO's event stream (core/slo.py).
                    _slo.observe("trunk_rtt", rtt_ms)
                self.rtt_ms = (
                    rtt_ms if self.rtt_ms == 0.0
                    else 0.25 * rtt_ms + 0.75 * self.rtt_ms
                )
        else:
            self.send(
                MessageType.TRUNK_HEARTBEAT,
                control_pb2.TrunkHeartbeatMessage(
                    sentAtMs=msg.sentAtMs, ack=True
                ),
            )

    async def _heartbeat_loop(self) -> None:
        while self.alive:
            try:
                await asyncio.sleep(
                    global_settings.federation_heartbeat_ms / 1000.0
                )
            except asyncio.CancelledError:
                return
            if not self.alive:
                return
            silent_s = time.monotonic() - self._last_rx
            if silent_s > global_settings.federation_trunk_timeout_ms / 1000.0:
                logger.warning(
                    "trunk to %s silent for %.2fs; declaring down",
                    self.peer_id, silent_s,
                )
                self._go_down("heartbeat timeout")
                return
            self.send(
                MessageType.TRUNK_HEARTBEAT,
                control_pb2.TrunkHeartbeatMessage(
                    sentAtMs=int(time.monotonic() * 1000.0), ack=False
                ),
            )

    # ---- teardown --------------------------------------------------------

    def _go_down(self, reason: str) -> None:
        if not self.alive:
            return
        self.alive = False
        logger.warning("trunk to %s down: %s", self.peer_id, reason)
        try:
            self._writer.transport.abort()
        except Exception:
            pass
        for t in self._tasks:
            if not t.done() and t is not asyncio.current_task():
                t.cancel()
        self._on_down(self.peer_id, self)

    def close(self) -> None:
        if self.alive:
            self.alive = False
            for t in self._tasks:
                if not t.done() and t is not asyncio.current_task():
                    t.cancel()
            try:
                self._writer.close()
            except Exception:
                pass

    def sever_for_test(self) -> None:
        """Abort the socket as if the link was cut (soak harness hook)."""
        self._go_down("test sever")


async def _read_hello(
    reader: asyncio.StreamReader, timeout: float = 5.0
):
    """(hello, handshake decoder, messages after the hello). The peer
    may write trunk traffic immediately after its hello (abort-notice
    flush on trunk-up) and TCP can coalesce it into the same read —
    the decoder and any already-decoded extras are handed to the
    TrunkLink so nothing is lost."""
    dec = FrameDecoder()
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError("trunk hello timeout")
        data = await asyncio.wait_for(reader.read(65536), timeout=remaining)
        if not data:
            raise ConnectionError("closed during trunk hello")
        hello = None
        extras = []
        for packet in dec.decode_packets(data):
            for mp in packet.messages:
                if hello is None:
                    if mp.msgType != MessageType.TRUNK_HELLO:
                        raise ConnectionError(
                            f"expected TRUNK_HELLO, got msgType {mp.msgType}"
                        )
                    hello = control_pb2.TrunkHelloMessage()
                    hello.ParseFromString(mp.msgBody)
                else:
                    extras.append(mp)
        if hello is not None:
            return hello, dec, extras


class TrunkManager:
    """Owns the trunk listener and the per-peer dial loops; hands
    established links to the federation plane."""

    def __init__(
        self,
        directory,
        on_message: Callable[[str, int, object], None],
        on_up: Callable[[str, TrunkLink], None],
        on_down: Callable[[str, TrunkLink], None],
    ):
        self.directory = directory
        self._on_message = on_message
        self._on_up = on_up
        self._on_down = on_down
        self.links: dict[str, TrunkLink] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._dial_tasks: dict[str, asyncio.Task] = {}
        self._stopping = False

    # ---- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        d = self.directory
        addr = d.trunk_addr(d.local_id)
        if addr:
            host, _, port = addr.rpartition(":")
            self._server = await asyncio.start_server(
                self._on_accept, host or "127.0.0.1", int(port)
            )
            logger.info("trunk listener on %s (gateway %s)", addr, d.local_id)
        for peer in d.peers():
            if d.local_id < peer:  # smaller id dials: one link per pair
                self._spawn_dial(peer)

    def stop(self) -> None:
        self._stopping = True
        if self._server is not None:
            self._server.close()
            self._server = None
        for t in self._dial_tasks.values():
            t.cancel()
        self._dial_tasks.clear()
        for link in list(self.links.values()):
            link.close()
        self.links.clear()

    def _spawn_dial(self, peer: str) -> None:
        old = self._dial_tasks.get(peer)
        if old is not None and not old.done():
            return
        self._dial_tasks[peer] = asyncio.ensure_future(self._dial_loop(peer))

    # ---- establishment ---------------------------------------------------

    def _install(self, peer: str, link: TrunkLink) -> None:
        prev = self.links.get(peer)
        if prev is not None and prev.alive:
            prev.close()
        self.links[peer] = link
        link.start()
        self._on_up(peer, link)

    def _link_down(self, peer: str, link: TrunkLink) -> None:
        if self.links.get(peer) is link:
            del self.links[peer]
        self._on_down(peer, link)
        if not self._stopping and self.directory.local_id < peer:
            self._spawn_dial(peer)

    async def _dial_loop(self, peer: str) -> None:
        st = global_settings
        attempt = 0
        while not self._stopping:
            addr = self.directory.trunk_addr(peer)
            if not addr:
                return
            host, _, port = addr.rpartition(":")
            try:
                reader, writer = await asyncio.open_connection(
                    host or "127.0.0.1", int(port)
                )
                writer.write(_frame(
                    MessageType.TRUNK_HELLO,
                    control_pb2.TrunkHelloMessage(
                        gatewayId=self.directory.local_id,
                        secret=self.directory.secret,
                    ),
                ))
                hello, dec, extras = await _read_hello(reader)
                if hello.gatewayId != peer or (
                    self.directory.secret
                    and hello.secret != self.directory.secret
                ):
                    raise ConnectionError(
                        f"trunk hello mismatch from {hello.gatewayId!r}"
                    )
            except (ConnectionError, OSError, TimeoutError) as e:
                delay = backoff_schedule(
                    attempt, st.federation_reconnect_base_ms,
                    st.federation_reconnect_max_ms, peer,
                )
                if attempt == 0 or attempt % 8 == 0:
                    logger.warning(
                        "trunk dial to %s failed (%s); retry in %.2fs "
                        "(attempt %d)", peer, e, delay, attempt,
                    )
                attempt += 1
                try:
                    await asyncio.sleep(delay)
                except asyncio.CancelledError:
                    return
                continue
            attempt = 0
            link = TrunkLink(
                peer, reader, writer, self._on_message, self._link_down,
                decoder=dec, pending=extras,
            )
            logger.info("trunk to %s established (dialed)", peer)
            self._install(peer, link)
            return  # _link_down respawns the dial loop when this link dies

    async def _on_accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        d = self.directory
        try:
            hello, dec, extras = await _read_hello(reader)
        except (ConnectionError, OSError, TimeoutError) as e:
            logger.warning("inbound trunk handshake failed: %s", e)
            try:
                writer.close()
            except Exception:
                pass
            return
        peer = hello.gatewayId
        if peer not in d.gateways or peer == d.local_id or (
            d.secret and hello.secret != d.secret
        ):
            logger.warning(
                "refused trunk from %r (unknown gateway or bad secret)", peer
            )
            try:
                writer.close()
            except Exception:
                pass
            return
        writer.write(_frame(
            MessageType.TRUNK_HELLO,
            control_pb2.TrunkHelloMessage(
                gatewayId=d.local_id, secret=d.secret
            ),
        ))
        link = TrunkLink(peer, reader, writer, self._on_message,
                         self._link_down, decoder=dec, pending=extras)
        logger.info("trunk from %s established (accepted)", peer)
        self._install(peer, link)
