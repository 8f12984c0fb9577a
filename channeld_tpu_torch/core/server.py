"""Gateway server: listeners, per-connection reactors, bootstrap.

Capability parity with the reference entrypoint wiring
(ref: cmd/main.go:39-54, pkg/channeld/connection.go:186-242):
ParseFlag -> InitLogs -> InitMetrics -> InitConnections -> InitChannels ->
InitSpatialController -> serve /metrics -> StartListening(SERVER) ->
[wait GlobalChannelPossessed] -> StartListening(CLIENT).

Transports: TCP (asyncio streams) and WebSocket (ref: connection_websocket.go);
both feed the same Connection byte path. A single 1ms flush task batches the
send queues of every connection (the reference runs one flush goroutine per
connection; a shared pump is the asyncio-idiomatic equivalent).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Optional

from ..chaos.injector import chaos as _chaos
from ..utils.logger import get_logger, init_logs
from . import events
from .channel import congestion_wait, connection_congested, init_channels
from .connection import (
    Connection,
    add_connection,
    drain_pending_flush,
    flush_pending_ingest,
    init_connections,
    requeue_flush,
)
from . import edge as _edge
from .edge import edge_tick
from .connection_recovery import connection_recovery_loop
from .ddos import init_anti_ddos, unauth_reaper_loop
from .settings import global_settings
from .types import ConnectionType

logger = get_logger("server")

# Outbound shed limit per connection. The reference's per-connection writer
# goroutine blocks on the socket, which is natural backpressure; an asyncio
# transport instead buffers in memory, so a stalled client subscribed to a
# busy channel would accumulate unbounded bytes. Past this limit the client
# is considered dead-slow and is disconnected (it can reconnect and recover
# via the C19 recovery path).
MAX_SEND_BUFFER = 4 * 1024 * 1024


class TcpTransport:
    """Byte sink over a raw asyncio.Transport (no StreamWriter layer)."""

    def __init__(self, transport: asyncio.Transport):
        self.transport = transport
        try:
            transport.set_write_buffer_limits(high=MAX_SEND_BUFFER)
        except (AttributeError, NotImplementedError):
            pass

    def write(self, data: bytes) -> None:
        t = self.transport
        if t.is_closing():
            return
        try:
            buffered = t.get_write_buffer_size()
        except (AttributeError, NotImplementedError):
            buffered = 0
        if buffered + len(data) > MAX_SEND_BUFFER:
            # Backstop behind the edge plane's transport gate
            # (edge_transport_high_bytes normally defers the pump well
            # before this point); double-entry counted like every other
            # edge reap (doc/edge_hardening.md).
            logger.warning("tcp peer %s too slow (%d bytes unsent); closing",
                           self.remote_addr(), buffered)
            _edge.ledgers.count_reap("send_buffer")
            t.close()
            return
        t.write(data)

    def get_write_buffer_size(self) -> int:
        """Unsent bytes buffered in the transport — the edge plane's
        flush gate reads this to detect a peer not draining its socket."""
        try:
            return self.transport.get_write_buffer_size()
        except (AttributeError, NotImplementedError):
            return 0

    def close(self) -> None:
        if not self.transport.is_closing():
            self.transport.close()

    def remote_addr(self) -> Optional[tuple]:
        return self.transport.get_extra_info("peername")


class _TcpServerProtocol(asyncio.Protocol):
    """Raw-protocol TCP receive path. The previous streams-based reactor
    paid a Future + task switch per read; at 10K mostly-1-message reads
    per second that machinery was a measurable share of the per-message
    budget. Backpressure keeps the reference semantics (a congested
    channel pauses exactly the connection that fed it,
    ref: channel.go:295-310) via transport.pause_reading()."""

    __slots__ = ("conn_type", "conn", "transport", "_draining")

    def __init__(self, conn_type: ConnectionType):
        self.conn_type = conn_type
        self.conn: Optional[Connection] = None
        self.transport: Optional[asyncio.Transport] = None
        self._draining = False

    def connection_made(self, transport: asyncio.Transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
        try:
            self.conn = add_connection(TcpTransport(transport), self.conn_type)
        except ConnectionRefusedError:
            transport.abort()

    def data_received(self, data: bytes) -> None:
        conn = self.conn
        if conn is None:
            return
        # Transport/connection faults target CLIENT sockets: the chaos
        # story is "the gateway degrades gracefully under hostile client
        # weather"; server-plane loss is exercised by the C19 recovery
        # scenarios instead.
        inject = _chaos.armed and self.conn_type == ConnectionType.CLIENT
        if inject:
            data = self._chaos_ingress(data)
            if data is None:
                return
        conn.on_bytes(data)
        if inject and not conn.is_closing() and _chaos.fire(
            "connection.eof_race"
        ):
            # The peer vanishes right after this read: EOF races any
            # deferred ingest batch — close() must deliver the final
            # burst before teardown (pinned by test_chaos).
            self.transport.close()
            conn.close(unexpected=True)
            return
        if conn.is_closing():
            self.transport.close()
            return
        if conn.has_pending() or connection_congested(conn):
            # Stop reading from *this* socket until the stash drains —
            # TCP backpressure, like the reference's blocking queue send.
            try:
                self.transport.pause_reading()
            except RuntimeError:
                return
            if not self._draining:
                self._draining = True
                asyncio.ensure_future(self._drain())

    def _chaos_ingress(self, data: bytes):
        """Armed-only transport fault gate: None = read consumed by the
        fault (socket reset), else the (possibly corrupted) bytes."""
        conn = self.conn
        if _chaos.fire("transport.reset"):
            # Peer reset before the read was processed: bytes lost, the
            # connection takes the unexpected-close path (recovery
            # eligibility, metrics, channel prune).
            self.transport.abort()
            conn.close(unexpected=True)
            return None
        if _chaos.fire("transport.truncate"):
            # Peer died mid-frame: a prefix arrives, then the reset. The
            # decoder must hold the partial frame without corrupting
            # state, and teardown must not double-count.
            conn.on_bytes(bytes(data[: max(1, len(data) // 2)]))
            self.transport.abort()
            conn.close(unexpected=True)
            return None
        if _chaos.fire("transport.corrupt"):
            # One flipped byte: framing/protobuf violations are
            # connection-fatal (never silently misparsed).
            data = bytes([data[0] ^ 0xFF]) + data[1:]
        return data

    async def _drain(self) -> None:
        conn = self.conn
        try:
            while not conn.is_closing() and (
                conn.has_pending() or connection_congested(conn)
            ):
                await congestion_wait(conn)
                if conn.has_pending() and not conn.flush_pending():
                    await asyncio.sleep(0)  # still full; wait again
        finally:
            self._draining = False
            if conn.is_closing():
                self.transport.close()
            elif not self.transport.is_closing():
                try:
                    self.transport.resume_reading()
                except RuntimeError:
                    pass

    def connection_lost(self, exc) -> None:
        # EOF/error: an unexpected close from the peer's side.
        if self.conn is not None:
            self.conn.close(unexpected=True)


class WebSocketTransport:
    """Wraps a ``websockets`` server connection as a byte sink; each frame
    is one binary WS message (ref: connection_websocket.go:14-61). Frames
    queue through a single drain task so pending bytes are bounded — a
    stalled WS peer is shed at MAX_SEND_BUFFER instead of accumulating
    fire-and-forget send tasks."""

    def __init__(self, ws, loop: asyncio.AbstractEventLoop):
        self.ws = ws
        self.loop = loop
        self._queue: deque[bytes] = deque()
        self._queued_bytes = 0
        self._drainer: Optional[asyncio.Future] = None
        self._shed = False

    def write(self, data: bytes) -> None:
        if self._shed:
            return
        if self._queued_bytes + len(data) > MAX_SEND_BUFFER:
            logger.warning("ws peer %s too slow (%d bytes unsent); closing",
                           self.remote_addr(), self._queued_bytes)
            self._shed = True
            self.close()
            return
        self._queue.append(data)
        self._queued_bytes += len(data)
        if self._drainer is None or self._drainer.done():
            self._drainer = asyncio.ensure_future(self._drain(), loop=self.loop)

    async def _drain(self) -> None:
        try:
            while self._queue:
                data = self._queue.popleft()
                self._queued_bytes -= len(data)
                await self.ws.send(data)
        except Exception:
            # The socket is dead: stop accepting writes and close, so the
            # connection doesn't look healthy while dropping every frame.
            self._queue.clear()
            self._queued_bytes = 0
            self._shed = True
            self.close()

    def close(self) -> None:
        asyncio.ensure_future(self.ws.close(), loop=self.loop)

    def remote_addr(self) -> Optional[tuple]:
        return self.ws.remote_address


def _parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)


async def start_listening(conn_type: ConnectionType, network: str, addr: str):
    """(ref: connection.go:186-242). Returns the server object."""
    host, port = _parse_addr(addr)
    if network == "tcp":
        # Deep accept backlog: a connect storm (10K clients joining after
        # a match start) must queue, not get RSTs (the reference's
        # listener inherits Go's somaxconn-sized backlog).
        loop = asyncio.get_running_loop()
        server = await loop.create_server(
            lambda: _TcpServerProtocol(conn_type), host, port, backlog=4096
        )
        logger.info("listening for %s on tcp %s:%d", conn_type.name, host, port)
        return server
    elif network in ("ws", "websocket"):
        import websockets

        loop = asyncio.get_running_loop()

        async def on_ws(ws):
            try:
                conn = add_connection(WebSocketTransport(ws, loop), conn_type)
            except ConnectionRefusedError:
                await ws.close()
                return
            from .channel import congestion_wait, connection_congested

            try:
                async for message in ws:
                    if isinstance(message, str):
                        message = message.encode()
                    conn.on_bytes(message)
                    if conn.is_closing():
                        break
                    while not conn.is_closing() and (
                        conn.has_pending() or connection_congested(conn)
                    ):
                        await congestion_wait(conn)
                        if conn.has_pending() and not conn.flush_pending():
                            await asyncio.sleep(0)
            except websockets.ConnectionClosed:
                pass
            finally:
                conn.close(unexpected=True)

        server = await websockets.serve(on_ws, host, port, max_size=1 << 20)
        logger.info("listening for %s on ws %s:%d", conn_type.name, host, port)
        return server
    elif network == "rudp":
        from .rudp import RudpServerProtocol, RudpSession

        class RudpTransport:
            def __init__(self, session: RudpSession, addr):
                self.session = session
                self.addr = addr

            def write(self, data: bytes) -> None:
                self.session.send_stream(data)

            def close(self) -> None:
                self.session.fin()

            def remote_addr(self):
                return self.addr

        def on_session(session: RudpSession, addr) -> None:
            try:
                conn = add_connection(RudpTransport(session, addr), conn_type)
            except ConnectionRefusedError:
                session.fin()
                return

            from .channel import connection_congested

            def on_stream(seg: bytes) -> None:
                # ARQ backpressure: while this connection's channels are
                # congested (or messages are stashed behind a full
                # queue), drop the segment *before* it is acked — the
                # peer retransmits, so nothing is lost and its send window
                # stalls, the reliable-UDP analog of pausing a TCP read.
                if conn.has_pending() or connection_congested(conn):
                    session.drop_unacked()
                    return
                conn.on_bytes(seg)
                if conn.has_pending():
                    asyncio.ensure_future(_drain_rudp_stash(conn))

            session.on_stream = on_stream
            # FIN / peer loss must close the gateway connection like the
            # TCP/WS reactors do (recovery depends on this close event).
            session.on_close = lambda: conn.close(unexpected=True)

        async def _drain_rudp_stash(conn) -> None:
            from .channel import congestion_wait

            while not conn.is_closing():
                await congestion_wait(conn)
                if conn.flush_pending():
                    break
                await asyncio.sleep(0)

        loop = asyncio.get_running_loop()
        transport, protocol = await loop.create_datagram_endpoint(
            lambda: RudpServerProtocol(on_session), local_addr=(host, port)
        )
        logger.info("listening for %s on rudp %s:%d", conn_type.name, host, port)
        return protocol
    elif network == "kcp":
        from .channel import congestion_wait, connection_congested
        from .kcp import KcpConn, KcpServerProtocol

        class KcpTransport:
            def __init__(self, session: KcpConn, addr):
                self.session = session
                self.addr = addr

            def write(self, data: bytes) -> None:
                self.session.send_stream(data)

            def close(self) -> None:
                self.session.close()

            def remote_addr(self):
                return self.addr

        def on_session(session: KcpConn, addr) -> None:
            try:
                conn = add_connection(KcpTransport(session, addr), conn_type)
            except ConnectionRefusedError:
                session.close()
                return

            def on_stream(seg: bytes) -> None:
                conn.on_bytes(seg)
                if conn.has_pending() or connection_congested(conn):
                    # KCP-native backpressure: pause delivery; the
                    # advertised receive window shrinks and the peer
                    # stalls. Resume once the congested channel drains
                    # and any stashed messages re-dispatched (lossless).
                    session.pause()
                    asyncio.ensure_future(_resume_when_clear(conn, session))

            session.on_stream = on_stream
            # Dead link / shed closes the gateway connection like the
            # TCP/WS reactors (recovery depends on this close event).
            session.on_close = lambda: conn.close(unexpected=True)

        async def _resume_when_clear(conn, session) -> None:
            while not conn.is_closing():
                await congestion_wait(conn)
                if conn.flush_pending():
                    break
                await asyncio.sleep(0)  # still full; wait for next drain
            if not session.closed:
                session.resume()

        loop = asyncio.get_running_loop()
        transport, protocol = await loop.create_datagram_endpoint(
            lambda: KcpServerProtocol(on_session), local_addr=(host, port)
        )
        logger.info("listening for %s on kcp %s:%d", conn_type.name, host, port)
        return protocol
    raise ValueError(f"unsupported network type: {network}")


async def flush_loop(interval: float = 0.001) -> None:
    """Shared send pump (ref: the per-conn 1ms flush goroutine,
    connection.go:180-184). The 1ms cadence is the packet-coalescing
    window; each cycle only visits connections that queued output since
    the last one, so idle connections cost nothing."""
    from . import metrics

    last_sample = 0.0
    while True:
        # Inbound first: deferred fast-path runs reach their channel
        # queue this cycle, so a tick landing between pump cycles sees
        # them no later than the per-read dispatch would have allowed.
        flush_pending_ingest()
        for conn in drain_pending_flush():
            if not conn.is_closing() and conn.send_queue:
                conn.flush(fair=True)
                if conn.send_queue and not conn.is_closing():
                    # Fairness carry-over: the cap left entries queued;
                    # they go out next cycle, after everyone else's turn.
                    requeue_flush(conn)
        # Advance the edge plane's slow-consumer/quarantine ladder —
        # free while no peer is in distress (core/edge.py).
        edge_tick()
        now = time.monotonic()
        if now - last_sample >= 5.0:  # asyncio_tasks gauge (goroutines analog)
            last_sample = now
            metrics.sample_runtime()
            # Re-publish the overload gauges on the same heartbeat so a
            # scrape never reads a stale level after a quiet stretch
            # (the governor also publishes on every transition).
            from .overload import governor

            metrics.overload_level.set(int(governor.level))
            metrics.overload_pressure.set(governor.pressure)
        await asyncio.sleep(interval)


async def drain_gateway(listeners: Optional[list] = None) -> dict:
    """Graceful SIGTERM drain (doc/device_recovery.md): stop accepting,
    park every client with a structured ``ServerBusyMessage`` (they back
    off ``overload_retry_after_ms`` and reconnect — to this gateway
    post-restart, or wherever a redirect points them), say goodbye on
    every live trunk so the control-plane leader re-maps this shard
    immediately instead of waiting out ``global_death_miss_epochs``, and
    write a final fsync'd snapshot through the shared ``write_snapshot``
    path. Returns a small report (tested directly; the SIGTERM handler
    is just this plus process exit)."""
    from .connection import all_connections
    from .message import MessageContext
    from .overload import governor
    from .types import MessageType
    from ..protocol import control_pb2

    report = {"clients_parked": 0, "goodbye_peers": 0, "snapshot": ""}
    logger.warning("SIGTERM: draining gateway (park clients, trunk "
                   "goodbye, final snapshot)")
    for srv in listeners or []:
        try:
            srv.close()
        except Exception:
            pass
    # Park clients: a structured retry-after, then the socket closes —
    # the same ServerBusyMessage shape L3 admission refusals use, so
    # every client library already knows how to honor it.
    busy = control_pb2.ServerBusyMessage(
        reason="shutdown",
        retryAfterMs=global_settings.overload_retry_after_ms,
        overloadLevel=int(governor.level),
    )
    for conn in list(all_connections().values()):
        if conn.connection_type != ConnectionType.CLIENT:
            continue
        if conn.is_closing():
            continue
        conn.send(MessageContext(
            msg_type=MessageType.SERVER_BUSY, msg=busy, channel_id=0,
        ))
        conn.flush()
        report["clients_parked"] += 1
    for conn in list(all_connections().values()):
        if conn.connection_type == ConnectionType.CLIENT:
            conn.close()
    # Trunk goodbye: peers drop the link now and the leader fast-tracks
    # the death declaration (federation/control.py on_peer_goodbye).
    if global_settings.federation_config:
        from ..federation import plane as fed_plane

        if fed_plane.active:
            report["goodbye_peers"] = fed_plane.announce_goodbye()
    # Final snapshot LAST, after the parks above stopped mutating
    # subscriber state: fsync-then-rename, so a kill -9 racing this
    # drain still leaves a consistent file.
    if global_settings.snapshot_path:
        from .snapshot import take_snapshot, write_snapshot
        from .wal import wal

        try:
            snap = take_snapshot()
            await asyncio.to_thread(
                write_snapshot, snap, global_settings.snapshot_path
            )
            wal.checkpoint(snap.walSeq)
            report["snapshot"] = global_settings.snapshot_path
            logger.info("final snapshot of %d channels written to %s",
                        len(snap.channels), global_settings.snapshot_path)
        except Exception:
            logger.exception("final shutdown snapshot failed")
    if global_settings.wal_path:
        # Final durability barrier off the loop: everything appended so
        # far fsyncs before the process exits (a parallel snapshot
        # failure above must not lose the journal tail either).
        from .wal import wal

        if wal.enabled:
            await asyncio.to_thread(wal.flush)
            wal.stop()
    logger.warning(
        "drain complete: %d clients parked, %d trunk peers said goodbye",
        report["clients_parked"], report["goodbye_peers"],
    )
    return report


def install_sigterm_drain(listeners: list, tasks: list,
                          serve_task: Optional[asyncio.Task] = None) -> None:
    """Wire SIGTERM to the graceful drain; after the drain the serve
    tasks are cancelled so run_server's gather returns and the process
    exits through the normal (trace-dump-registered) teardown.
    ``serve_task`` (run_server's own task) is cancelled too: during the
    wait-for-master boot phase run_server blocks on the GLOBAL-channel
    possession event, not on any task in ``tasks`` — without this a
    SIGTERM in that window would drain and then hang forever, exactly
    the stuck-boot case where an operator reaches for SIGTERM."""
    import signal

    def _on_sigterm() -> None:
        async def _drain_and_exit():
            try:
                await drain_gateway(listeners)
            finally:
                for t in tasks:
                    t.cancel()
                if serve_task is not None and not serve_task.done():
                    serve_task.cancel()

        asyncio.ensure_future(_drain_and_exit())

    try:
        asyncio.get_running_loop().add_signal_handler(
            signal.SIGTERM, _on_sigterm
        )
    except (NotImplementedError, RuntimeError):
        logger.info("SIGTERM drain unavailable on this platform")


async def run_server(argv: Optional[list[str]] = None) -> None:
    """Full bootstrap (ref: cmd/main.go:12-56)."""
    global_settings.parse_flags(argv)
    # Map the reference's zap levels (-4 Trace..2 Error) onto logging,
    # clamping out-of-range values toward the nearest end.
    level_map = {-4: 4, -3: 6, -2: 8, -1: 10, 0: 20, 1: 30, 2: 40}
    zap_level = global_settings.log_level
    if zap_level is None:
        zap_level = 0
    zap_level = max(-4, min(2, zap_level))
    init_logs(
        level=level_map[zap_level],
        log_file=global_settings.log_file,
        development=global_settings.development,
    )
    if global_settings.log_file:
        from ..utils.logger import attach_security_log_file

        attach_security_log_file(global_settings.log_file)
    if global_settings.profile:
        from .profiling import start_profiling

        start_profiling(global_settings.profile, global_settings.profile_path)
    # Flight recorder (doc/observability.md): configure from the -trace*
    # flags, then wire the diagnostic signals — SIGUSR1 dumps live
    # tasks/threads (no -profile tasks pre-arming needed), SIGUSR2 dumps
    # the recorder ring as Perfetto JSON — and the shutdown dump.
    from . import tracing
    from .affinity import configure_from_settings as configure_affinity
    from .profiling import install_task_dump_signal

    configure_affinity()
    tracing.configure_from_settings()
    install_task_dump_signal(global_settings.profile_path)
    tracing.install_trace_dump_signal()
    if global_settings.trace_enabled:
        tracing.register_shutdown_dump()
        logger.info(
            "flight recorder armed: %d spans/thread, anomaly dumps keep "
            "the last %d ticks under %s/ (SIGUSR2 = manual dump, "
            "SIGUSR1 = task dump; doc/observability.md)",
            global_settings.trace_ring_spans,
            global_settings.trace_dump_ticks,
            global_settings.profile_path,
        )
    if global_settings.chaos_config:
        from ..chaos import arm_from_file

        arm_from_file(global_settings.chaos_config)
        logger.warning(
            "CHAOS ARMED from %s — deterministic fault injection is live",
            global_settings.chaos_config,
        )
    init_connections(global_settings.server_fsm, global_settings.client_fsm)
    init_channels()
    init_anti_ddos()
    if global_settings.overload_enabled:
        logger.info(
            "overload governor armed: ladder L0-L3, enter=%s exit=%s, "
            "retry-after %dms (doc/overload.md)",
            global_settings.overload_enter_thresholds,
            global_settings.overload_exit_thresholds,
            global_settings.overload_retry_after_ms,
        )
    if global_settings.balancer_enabled:
        logger.info(
            "spatial load balancer armed: imbalance enter=%.2f exit=%.2f, "
            "budget %d/epoch (%d ticks), cooldown %d ticks "
            "(doc/balancer.md)",
            global_settings.balancer_imbalance_enter,
            global_settings.balancer_imbalance_exit,
            global_settings.balancer_budget_per_epoch,
            global_settings.balancer_epoch_ticks,
            global_settings.balancer_cooldown_ticks,
        )

    # Fail boot on a missing auth provider outside development: raising at
    # auth time would be swallowed by the per-message isolator and the
    # misconfiguration would only surface as dangling unauthenticated
    # connections in the logs.
    from .auth import get_auth_provider

    if get_auth_provider() is None and not global_settings.development:
        logger.error(
            "no auth provider configured and not in development mode; "
            "set one with set_auth_provider() before run_server()"
        )
        raise SystemExit(1)

    from ..spatial.controller import init_spatial_controller

    init_spatial_controller()

    fed_plane = None
    if global_settings.federation_config:
        from ..federation import init_federation, plane as fed_plane
        from ..spatial.controller import get_spatial_controller

        init_federation(
            global_settings.federation_config,
            global_settings.federation_gateway_id,
            get_spatial_controller(),
        )
        logger.info(
            "federation armed: gateway %r in %s (doc/federation.md)",
            global_settings.federation_gateway_id,
            global_settings.federation_config,
        )

    # Delivery-SLO plane (doc/observability.md): ingest->fan-out
    # latency stamping, burn-rate tracking, breach anomaly dumps, and
    # (federated) the fleet metric digests on the control epoch.
    from . import slo as slo_mod

    slo_mod.configure_from_settings()
    if global_settings.slo_enabled:
        logger.info(
            "SLO plane armed: %s (burn-rate windows per SLO; breaches "
            "freeze a flight-recorder dump; doc/observability.md)",
            ", ".join(sorted(slo_mod.slo.status())),
        )

    # The ops surface replaces the bare metrics listener: /metrics is
    # one of its routes (scrape configs unchanged), /healthz + /readyz
    # feed the k8s/compose probes, /introspect + /fleet feed operators
    # and scripts/fleetctl.py (doc/observability.md).
    from .opshttp import serve_ops

    if global_settings.metrics_port:
        try:
            serve_ops(global_settings.metrics_port)
        except OSError:
            logger.warning("metrics port %d unavailable; ops surface "
                           "disabled", global_settings.metrics_port)

    # Durable-state boot BEFORE the trunks/listeners come up: restore
    # the snapshot and replay the WAL tail (doc/persistence.md) so the
    # resurrection announce is armed by the time the first trunk
    # handshakes, then start the journal writer continuing the sequence
    # above everything replay observed.
    if global_settings.wal_path:
        from .wal import boot_replay, wal

        replay_report = boot_replay(
            global_settings.snapshot_path, global_settings.wal_path
        )
        wal.start(global_settings.wal_path,
                  initial_seq=replay_report.get("max_seq", 0))
    elif global_settings.snapshot_path:
        from .snapshot import boot_restore

        # Restore-at-boot (corrupt/missing files never block boot).
        boot_restore(global_settings.snapshot_path)

    tasks = [
        asyncio.ensure_future(flush_loop()),
        asyncio.ensure_future(unauth_reaper_loop()),
    ]
    if fed_plane is not None:
        # Trunk listener + per-peer dial loops + the handover timeout
        # reaper; staged-handle expiry needs the recovery reaper too.
        await fed_plane.start()
        if not global_settings.server_conn_recoverable:
            tasks.append(asyncio.ensure_future(connection_recovery_loop()))
    if global_settings.server_conn_recoverable:
        tasks.append(asyncio.ensure_future(connection_recovery_loop()))

    if global_settings.snapshot_path:
        from .snapshot import snapshot_loop

        # The periodic skip-unchanged fsync-then-rename writer on
        # -snapshot-interval (each write checkpoints the WAL).
        tasks.append(asyncio.ensure_future(snapshot_loop(
            global_settings.snapshot_path, global_settings.snapshot_interval_s
        )))

    listeners: list = []
    try:
        listeners.append(await start_listening(
            ConnectionType.SERVER,
            global_settings.server_network,
            global_settings.server_address,
        ))
    except OSError as e:
        logger.error(
            "cannot listen on %s %s: %s", global_settings.server_network,
            global_settings.server_address, e,
        )
        raise SystemExit(1)
    # SIGTERM drains instead of killing mid-tick: final fsync'd
    # snapshot, clients parked with ServerBusyMessage{retryAfterMs},
    # trunk goodbye so the shard re-maps immediately
    # (doc/device_recovery.md). The current task is handed over so a
    # SIGTERM during the wait-for-master phase below exits instead of
    # draining into a hang.
    try:
        serve_task = asyncio.current_task()
    except RuntimeError:
        serve_task = None
    install_sigterm_drain(listeners, tasks, serve_task)
    try:
        if global_settings.client_network_wait_master_server:
            logger.info("waiting for the GLOBAL channel to be possessed...")
            await events.global_channel_possessed.wait()
        listeners.append(await start_listening(
            ConnectionType.CLIENT,
            global_settings.client_network,
            global_settings.client_address,
        ))
        await asyncio.gather(*tasks)
    except asyncio.CancelledError:
        logger.info("serve tasks cancelled; gateway exiting")
