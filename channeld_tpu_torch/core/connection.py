"""Connection layer: registry, id allocation, dispatch, send batching.

Capability parity with the reference connection layer
(ref: pkg/channeld/connection.go). Each connection owns a frame decoder
(bytes in), a send queue of MessagePacks flushed as batched packets with
oversize carry-over (bytes out), a per-connection FSM filter, and the
replay recording hook. Transport IO is behind the small ``Transport``
seam so tests can use in-process pipes, mirroring the reference's
``MessageSender`` / ``net.Pipe`` seams.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional, Protocol

from google.protobuf.message import DecodeError as _DecodeError

from ..protocol import FramingError, MESSAGE_TEMPLATES, encode_frame, wire_pb2

try:
    from ..native import codec as _native_codec
except ImportError:
    _native_codec = None
from ..protocol.framing import FrameDecoder, HEADER_SIZE, MAX_PACKET_SIZE
from ..protocol import snappy as snappy_codec
from ..utils.idalloc import hash_string
from ..utils.logger import get_logger
from . import edge as _edge
from . import events, metrics
from .fsm import MessageFsm
from .tracing import recorder as _trace
from .settings import global_settings
from .types import (
    CompressionType,
    ConnectionState,
    ConnectionType,
    MessageType,
)

logger = get_logger("connection")

# Hot-path handles resolved lazily by _bind_hot_handles (circular
# imports prevent binding them at module import time).
_get_channel = None
_MESSAGE_MAP = None
_handle_c2s_user = None
_handle_s2c_user = None


def _bind_hot_handles() -> None:
    """One-time late binding (circular-import-safe); the previous
    per-call ``from .channel import ...`` form ran the import machinery
    ~650K times in a 27s load profile."""
    global _get_channel, _MESSAGE_MAP, _handle_c2s_user, _handle_s2c_user
    from .channel import get_channel as _gc
    from .message import (
        MESSAGE_MAP as _mm,
        handle_client_to_server_user_message as _c2s,
        handle_server_to_client_user_message as _s2c,
    )
    _get_channel, _MESSAGE_MAP = _gc, _mm
    _handle_c2s_user, _handle_s2c_user = _c2s, _s2c


class _ForwardBatch:
    """One batched-ingest run: pre-encoded owner send-queue entries for
    plain user-space forwards to GLOBAL, produced by the native codec's
    parse_forward. Travels through receive_message / the pending stash
    like a MessagePack so ordering and backpressure semantics hold.
    ``ingest_ns`` is the monotonic stamp of the OLDEST read folded into
    the run — the delivery-SLO plane (core/slo.py) measures the held
    batch's true age, stash-and-retry included."""

    __slots__ = ("entries", "counts", "n_packets", "ingest_ns")

    def __init__(self, entries: list, counts: dict, n_packets: int,
                 ingest_ns: int = 0):
        self.entries = entries
        self.counts = counts  # msgType -> n, for metrics attribution
        self.n_packets = n_packets
        self.ingest_ns = ingest_ns


class Transport(Protocol):
    """Byte sink for a connection; implemented by TCP/WebSocket adapters
    and by test pipes."""

    def write(self, data: bytes) -> None: ...
    def close(self) -> None: ...
    def remote_addr(self) -> Optional[tuple]: ...


class MessageSender(Protocol):
    """Send-path seam (ref: connection.go:39-41). Tests may swap it to
    capture outgoing messages."""

    def send(self, conn: "Connection", ctx) -> None: ...


def _varint_size(v: int) -> int:
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n


def _entry_size(channel_id: int, broadcast: int, stub_id: int, msg_type: int,
                body_len: int) -> int:
    """Exact encoded size of one MessagePack entry (proto3 zero-omission)."""
    size = 0
    for v in (channel_id, broadcast, stub_id, msg_type):
        if v:
            size += 1 + _varint_size(int(v))
    if body_len:
        size += 1 + _varint_size(body_len) + body_len
    return 1 + _varint_size(size) + size


def _pack_size(ctx, body_len: int) -> int:
    return _entry_size(ctx.channel_id, ctx.broadcast, ctx.stub_id,
                       ctx.msg_type, body_len)


class QueuedMessagePackSender:
    """Marshal into the send queue; flushed by the connection's pump
    (ref: connection.go:54-84). Queue entries are light tuples
    (channelId, broadcast, stubId, msgType, body) so the native packet
    encoder consumes them without protobuf object churn."""

    def send(self, conn: "Connection", ctx) -> None:
        body = ctx.raw_body if ctx.raw_body is not None else ctx.msg.SerializeToString()
        # Exact size math only near the limit: the entry overhead beyond
        # the body is at most 4 varint fields (6 bytes each) + the
        # body/entry length prefixes — well under 64 bytes.
        if (len(body) + 64 >= MAX_PACKET_SIZE - HEADER_SIZE
                and _pack_size(ctx, len(body)) >= MAX_PACKET_SIZE - HEADER_SIZE):
            conn.logger.warning(
                "message dropped: size %d exceeds packet limit", len(body)
            )
            return
        if not conn.is_closing():
            env = conn.envelope
            if env.quarantined:
                # Egress frozen: the peer gets nothing but the final
                # structured disconnect (counted, never silent).
                _edge.ledgers.count_egress_drop("quarantine")
                return
            # No int() casts: enum values are int subclasses and both
            # packet encoders take them as-is.
            conn.send_queue.append(
                (ctx.channel_id, ctx.broadcast, ctx.stub_id,
                 ctx.msg_type, body)
            )
            _pending_flush.add(conn)
            if global_settings.edge_enabled:
                env.queue_bytes += len(body) + _edge.ENTRY_OVERHEAD
                _edge.note_egress(conn)


class Connection:
    def __init__(
        self,
        conn_id: int,
        connection_type: ConnectionType,
        transport: Transport,
        fsm: Optional[MessageFsm],
    ):
        self.id = conn_id
        self.connection_type = ConnectionType(connection_type)
        self.compression_type = CompressionType.NO_COMPRESSION
        self.transport = transport
        self.decoder = FrameDecoder()
        # Messages that hit a full channel queue, head-first; reads stay
        # paused until flush_pending() re-dispatches them (lossless
        # backpressure; bounded by one read's worth of messages).
        self._pending_msgs: deque = deque()
        self.sender: MessageSender = QueuedMessagePackSender()
        # (channelId, broadcast, stubId, msgType, body) tuples.
        self.send_queue: list[tuple] = []
        self.pit = ""
        self.fsm = fsm
        self.fsm_disallowed_counter = 0
        self.state = ConnectionState.UNAUTHENTICATED
        self.conn_time = time.monotonic()
        self.close_handlers: list[Callable[[], None]] = []
        self.replay_session = None
        self.spatial_subscriptions: dict[int, object] = {}
        self.recover_handle = None
        self.logger = get_logger(f"conn.{self.connection_type.name}.{conn_id}")
        # Per-connection edge-plane state: egress occupancy, the
        # slow-consumer ladder position, the ingress token bucket
        # (core/edge.py; doc/edge_hardening.md).
        self.envelope = _edge.ConnectionEnvelope()
        # Per-connection labels never change; resolving the labelled
        # children once keeps prometheus' .labels() tuple-building and
        # validation out of the per-packet hot path (~8% of active CPU
        # under a 64-client profile).
        ct_name = self.connection_type.name
        self._m_bytes_received = metrics.bytes_received.labels(conn_type=ct_name)
        self._m_packet_received = metrics.packet_received.labels(conn_type=ct_name)
        self._m_packet_dropped = metrics.packet_dropped.labels(conn_type=ct_name)
        self._m_packet_sent = metrics.packet_sent.labels(conn_type=ct_name)
        self._m_bytes_sent = metrics.bytes_sent.labels(conn_type=ct_name)
        self._m_packet_combined = metrics.packet_combined.labels(conn_type=ct_name)
        self._m_msg_sent = metrics.msg_sent.labels(
            conn_type=ct_name, channel_type="", msg_type=""
        )
        self._m_msg_received: dict[tuple, object] = {}
        # (channel_type, msgType) -> count since the last publish; see
        # _publish_msg_received.
        self._msg_received_pending: dict[tuple, int] = {}
        # Deferred fast-path run [entries, counts, n_packets,
        # ingest_ns]; dispatched by flush_ingest (1ms pump / channel
        # tick / ordering points).
        self._fast_run: Optional[list] = None
        # Monotonic stamp of the read currently being dispatched; the
        # delivery-SLO ingest mark every receive_message of this read
        # inherits (flush_pending restores each stashed message's own
        # original stamp before re-dispatch).
        self._rx_stamp_ns = 0
        if self._is_packet_recording_enabled():
            from ..replay.session import ReplaySession

            self.replay_session = ReplaySession()

    # ---- receive path ----------------------------------------------------

    def on_bytes(self, data: bytes) -> None:
        """Feed raw stream bytes; dispatches every complete packet.
        Fatal framing/parse errors close the connection (ref: readPacket)."""
        if self.envelope.quarantined:
            # Quarantine discards ingress outright: the peer already
            # earned its structured disconnect, and parsing its bytes
            # would keep paying for an abuser (doc/edge_hardening.md).
            return
        try:
            bodies = self.decoder.feed(data)
        except Exception as e:  # framing violations are connection-fatal
            self.logger.warning("bad inbound frame, closing connection: %s", e)
            _edge.ledgers.count_malformed("framing")
            metrics.connection_closed.labels(
                conn_type=self.connection_type.name
            ).inc()
            self.close()
            return
        self._m_bytes_received.inc(len(data))
        # Mirror the peer's compression choice (ref: readPacket sets
        # c.compressionType from the inbound tag): once a peer sends
        # snappy, replies are compressed too.
        if (
            self.decoder.peer_compression == 1
            and self.compression_type == CompressionType.NO_COMPRESSION
        ):
            self.compression_type = CompressionType.SNAPPY
        if not bodies:
            return
        if global_settings.edge_enabled and not _edge.note_frames(
            self, len(bodies)
        ):
            return  # flood cap quarantined the peer; the read is discarded
        # One ingest stamp per read batch: the delivery-SLO mark every
        # message of this read carries (core/slo.py). monotonic_ns is
        # ~40ns; stamping per read (not per message) keeps the 10K-conn
        # singleton-read floor untouched.
        rx_ns = time.monotonic_ns()
        self._rx_stamp_ns = rx_ns
        recording = (self._is_packet_recording_enabled()
                     and self.replay_session is not None)
        # The batched ingest path: packets that are nothing but plain
        # user-space forwards to GLOBAL skip protobuf entirely — the
        # native codec emits ready-to-queue owner entries, accumulated
        # across consecutive packets into one channel-queue item.
        parse_forward = getattr(_native_codec, "parse_forward", None)
        fast_eligible = (
            parse_forward is not None  # guards a stale codec build too
            and not recording
            and self.connection_type == ConnectionType.CLIENT
        )
        if fast_eligible and _MESSAGE_MAP is None:
            _bind_hot_handles()
        MESSAGE_MAP = _MESSAGE_MAP
        receive_message = self.receive_message
        pending_msgs = self._pending_msgs
        self._m_packet_received.inc(len(bodies))
        fsm = self.fsm
        conn_id = self.id
        try:
            for body in bodies:
                if fast_eligible:
                    res = parse_forward(body, conn_id, 0, 100)
                    # Registered user-space handlers (MSG_SPAWN=103 etc.,
                    # models/engine_adapter.py) take precedence over the
                    # raw-forward route, exactly like the slow path's
                    # MESSAGE_MAP dispatch — a batch containing any
                    # registered type goes through protobuf (advisor r5
                    # high: mis-routing them skipped spawn registration).
                    if res is not None and (
                        fsm is None or fsm.user_space_fast(res[1])
                    ) and not any(mt in MESSAGE_MAP for mt in res[1]):
                        if pending_msgs:
                            # Congested: stash the parsed batch behind the
                            # existing backlog (same ordering the slow
                            # path would give) — re-parsing congested
                            # traffic through protobuf was the dominant
                            # overload-regime cost in the r5 profile.
                            pending_msgs.append(
                                (_ForwardBatch(res[0], res[1], 1, rx_ns),
                                 [False], rx_ns)
                            )
                            continue
                        # Defer dispatch to the 1ms pump (or the next
                        # channel tick, whichever first): singleton reads
                        # then share one channel-queue hop instead of
                        # paying it per read. Ordering holds — a slow
                        # body below flushes the deferred run first.
                        run = self._fast_run
                        if run is None:
                            # The run keeps its OLDEST read's stamp: a
                            # held batch's delivery latency is the age
                            # of its most-delayed message, honestly.
                            self._fast_run = [res[0], res[1], 1, rx_ns]
                            _pending_ingest.add(self)
                        else:
                            run[0].extend(res[0])
                            rc = run[1]
                            for mt, n in res[1].items():
                                rc[mt] = rc.get(mt, 0) + n
                            run[2] += 1
                        continue
                if self._fast_run is not None:
                    self.flush_ingest()
                packet = wire_pb2.Packet()
                packet.ParseFromString(body)  # DecodeError -> close below
                if recording:
                    self.replay_session.record(packet)
                # One token per packet: packet_dropped increments at most
                # once per originating packet, whether the drop happens
                # here or later when a stashed tail flushes.
                drop_token = [False]
                for i, mp in enumerate(packet.messages):
                    if pending_msgs:
                        # Order must hold: once anything is stashed, every
                        # later message queues behind it.
                        pending_msgs.extend(
                            (m, drop_token, rx_ns)
                            for m in packet.messages[i:]
                        )
                        break
                    result = receive_message(mp)
                    if result is None:  # target queue full: stash, not drop
                        pending_msgs.extend(
                            (m, drop_token, rx_ns)
                            for m in packet.messages[i:]
                        )
                        break
                    if not result and not drop_token[0]:
                        # Counted once per packet (the reference's
                        # packet-level dropped counter), whatever the
                        # drop reason.
                        drop_token[0] = True
                        self._m_packet_dropped.inc()
        except _DecodeError as e:  # bad protobuf: connection-fatal. Other
            # exceptions (handler/event bugs) must propagate so the
            # transport layer closes with unexpected=True and recoverable
            # server conns stay eligible for recovery.
            self.logger.warning("bad inbound packet, closing connection: %s", e)
            _edge.ledgers.count_malformed("packet")
            metrics.connection_closed.labels(
                conn_type=self.connection_type.name
            ).inc()
            self.close()
            return
        self._publish_msg_received()

    def flush_ingest(self) -> None:
        """Dispatch the deferred fast-path run, if any. Called by the
        1ms pump / channel tick, and inline whenever ordering demands it
        (a slow body or a close)."""
        run = self._fast_run
        if run is None:
            return
        self._fast_run = None
        self._dispatch_forward_run(run)
        self._publish_msg_received()

    def _dispatch_forward_run(self, run: list) -> None:
        """Hand one accumulated fast-path run to the channel queue,
        with the same stash/drop accounting as per-message dispatch."""
        batch = _ForwardBatch(run[0], run[1], run[2], run[3])
        result = self.receive_message(batch)
        if result is None:  # queue full: stash for flush_pending
            self._pending_msgs.append((batch, [False], run[3]))
        elif result is False:
            # The whole run failed (no target channel): one drop per
            # originating packet, like the per-message path.
            self._m_packet_dropped.inc(run[2])

    def has_pending(self) -> bool:
        return bool(self._pending_msgs)

    def pending_head_channel(self) -> Optional[int]:
        """Channel id the head of the pending stash targets (what a
        failing flush_pending is blocked on); None with nothing stashed.
        Forward batches always target GLOBAL (0)."""
        if not self._pending_msgs:
            return None
        mp = self._pending_msgs[0][0]
        return 0 if type(mp) is _ForwardBatch else mp.channelId

    def flush_pending(self) -> bool:
        """Re-dispatch stashed messages in order; True when drained.
        Stops (False) at the first message whose channel queue is still
        full — call again after the next drain signal."""
        while self._pending_msgs:
            mp, drop_token, stamp = self._pending_msgs[0]
            # Re-dispatch under the message's ORIGINAL ingest stamp: a
            # stash-held message's delivery latency must include the
            # hold (never re-stamped smaller, never negative).
            self._rx_stamp_ns = stamp
            result = self.receive_message(mp)
            if result is None:
                self._publish_msg_received()
                return False
            self._pending_msgs.popleft()
            if result is False and not drop_token[0]:
                drop_token[0] = True
                self._m_packet_dropped.inc(
                    mp.n_packets if type(mp) is _ForwardBatch else 1
                )
        self._publish_msg_received()
        return True

    def receive_message(self, mp: wire_pb2.MessagePack):
        """Dispatch one message pack to its channel queue. True = enqueued
        (or consumed), False = dropped (bad message / FSM / no channel),
        None = target queue full — NOT processed; the caller must stash
        the pack and retry once backpressure drains
        (ref: connection.go:547-615; the reference's blocking queue send
        maps to the stash + paused reads)."""
        if _get_channel is None:
            _bind_hot_handles()
        get_channel = _get_channel
        MESSAGE_MAP = _MESSAGE_MAP
        handle_client_to_server_user_message = _handle_c2s_user
        handle_server_to_client_user_message = _handle_s2c_user

        if type(mp) is _ForwardBatch:
            # Re-take the FSM verdict at dispatch time (advisor r5 low):
            # a batch stashed behind pending messages can be dispatched
            # after those messages transitioned the FSM, making the
            # parse-time verdict stale — the slow path evaluates
            # is_allowed at dispatch, so this path must too.
            if self.fsm is not None and not self.fsm.user_space_fast(mp.counts):
                for mt, n in mp.counts.items():
                    for _ in range(n):
                        events.fsm_disallowed.broadcast(
                            events.FsmDisallowedData(
                                connection=self, msg_type=mt
                            )
                        )
                self.logger.warning(
                    "batched forward rejected by FSM in state %s",
                    self.fsm.current.name,
                )
                return False
            channel = get_channel(0)
            if channel is None:
                return False
            if not channel.put_forward_batch(mp.entries, self,
                                             ingest_ns=mp.ingest_ns):
                return None  # queue full: caller stashes and retries
            pending = self._msg_received_pending
            ct = channel.channel_type
            for mt, n in mp.counts.items():
                key = (ct, mt)
                pending[key] = pending.get(key, 0) + n
            return True

        channel = get_channel(mp.channelId)
        if channel is None:
            if mp.msgType not in (
                MessageType.SUB_TO_CHANNEL,
                MessageType.UNSUB_FROM_CHANNEL,
            ):
                self.logger.warning(
                    "can't find channel %d for msgType %d", mp.channelId, mp.msgType
                )
            return False

        raw_body = None
        entry = MESSAGE_MAP.get(mp.msgType)
        if entry is None and mp.msgType < MessageType.USER_SPACE_START:
            self.logger.error("undefined message type %d", mp.msgType)
            _edge.ledgers.count_malformed("message")
            return False

        if self.fsm is not None and not self.fsm.is_allowed(mp.msgType):
            events.fsm_disallowed.broadcast(
                events.FsmDisallowedData(connection=self, msg_type=mp.msgType)
            )
            self.logger.warning(
                "message type %d not allowed in state %s",
                mp.msgType,
                self.fsm.current.name,
            )
            return False

        if mp.msgType >= MessageType.USER_SPACE_START and entry is None:
            if self.connection_type == ConnectionType.CLIENT:
                # client -> server: body stays opaque (never deserialized).
                msg = wire_pb2.ServerForwardMessage(
                    clientConnId=self.id, payload=mp.msgBody
                )
                handler = handle_client_to_server_user_message
                # raw_body stays None on purpose: the send path encodes
                # lazily exactly once (C-level, shared across recipients),
                # and drop paths (removing channel, owner in recovery,
                # ownerless) then pay zero serialization. A hand-rolled
                # eager encode measured SLOWER than upb (787 vs 656 ns).
            else:
                msg = wire_pb2.ServerForwardMessage()
                try:
                    msg.ParseFromString(mp.msgBody)
                except Exception:
                    self.logger.exception("unmarshalling ServerForwardMessage")
                    _edge.ledgers.count_malformed("message")
                    return False
                handler = handle_server_to_client_user_message
                # Pure forward (no registered handler exists for this type,
                # so nothing mutates the message): the inbound bytes ARE
                # the outbound bytes — skip the re-encode entirely.
                raw_body = mp.msgBody
        else:
            tmpl = entry.template
            # Registry entries may hold the class or a prototype instance;
            # either way every dispatch gets a fresh message (ref: proto.Clone).
            msg = tmpl() if isinstance(tmpl, type) else type(tmpl)()
            try:
                msg.ParseFromString(mp.msgBody)
            except Exception:
                self.logger.exception("unmarshalling message type %d", mp.msgType)
                _edge.ledgers.count_malformed("message")
                return False
            handler = entry.handler

        if not channel.put_message(msg, handler, self, mp, raw_body=raw_body,
                                   external=True,
                                   ingest_ns=self._rx_stamp_ns):
            return None  # queue full: caller stashes and retries (no drop)
        # FSM advance only after the enqueue succeeds: the queue-full
        # retry path re-enters this function with the same pack, and a
        # transition applied on the failed attempt would either fire
        # twice or make the retry disallowed by its own first attempt.
        if self.fsm is not None:
            self.fsm.on_received(mp.msgType)
        # Deferred inc: prometheus child.inc() takes a mutex per call;
        # accumulate per (channel_type, msgType) and let the read-batch
        # boundary (on_bytes / flush_pending) publish the counts.
        key = (channel.channel_type, mp.msgType)
        pending = self._msg_received_pending
        pending[key] = pending.get(key, 0) + 1
        return True

    def _publish_msg_received(self) -> None:
        pending = self._msg_received_pending
        if not pending:
            return
        self._msg_received_pending = {}
        for key, count in pending.items():
            child = self._m_msg_received.get(key)
            if child is None:
                child = self._m_msg_received[key] = metrics.msg_received.labels(
                    conn_type=self.connection_type.name,
                    channel_type=key[0].name,
                    msg_type=str(key[1]),
                )
            child.inc(count)

    # ---- send path -------------------------------------------------------

    def send(self, ctx) -> None:
        if self.is_closing():
            return
        self.sender.send(self, ctx)

    def flush(self, fair: bool = False) -> None:
        """Batch queued messages into <=64KB packets, compress, frame,
        write (ref: connection.go:626-714). The native codec builds the
        protobuf wire bytes directly from the queued tuples.

        ``fair=True`` (the shared pump) caps one call at
        edge_flush_fair_msgs entries so a single hot connection cannot
        starve the 1ms cycle for every other peer; the remainder stays
        queued and the pump re-schedules it next cycle. Direct callers
        (disconnect, drain) flush everything."""
        if not self.send_queue:
            return
        env = self.envelope
        if fair and global_settings.edge_enabled:
            # Transport-backpressure gate (doc/edge_hardening.md): a peer
            # that stops draining its socket must not hide in the
            # transport's write buffer — leave the entries queued so the
            # envelope (bounded, counted) absorbs them and the
            # slow-consumer ladder sees the backlog. The pump re-queues
            # this connection next cycle; direct flushes (disconnect,
            # drain) bypass the gate.
            gate = global_settings.edge_transport_high_bytes
            if gate > 0:
                getter = getattr(self.transport, "get_write_buffer_size", None)
                if getter is not None and getter() > gate:
                    return
        limit = (global_settings.edge_flush_fair_msgs
                 if fair and global_settings.edge_enabled else 0)
        if limit and len(self.send_queue) > limit:
            batch = self.send_queue[:limit]
            del self.send_queue[:limit]
            env.queue_bytes -= sum(
                len(e[4]) for e in batch
            ) + len(batch) * _edge.ENTRY_OVERHEAD
            if env.queue_bytes < 0:
                env.queue_bytes = 0
        else:
            batch, self.send_queue = self.send_queue, []
            env.queue_bytes = 0
        _edge.note_drain(self)
        ct = self.compression_type
        if ct == CompressionType.SNAPPY and not snappy_codec.available():
            ct = CompressionType.NO_COMPRESSION

        # Any encode failure must stay contained to this connection: the
        # shared flush pump calls flush() for every connection in turn.
        try:
            if _native_codec is not None:
                frames, counts = _native_codec.encode_packets(batch, int(ct))
            else:
                frames, counts = self._encode_packets_py(batch, int(ct))
        except Exception as e:
            self.logger.error("packet encode failed, dropping batch: %s", e)
            return

        for frame, count in zip(frames, counts):
            try:
                self.transport.write(frame)
            except Exception as e:
                self.logger.error("error writing packet: %s", e)
                break
            self._m_packet_sent.inc()
            self._m_bytes_sent.inc(len(frame))
            if count > 1:
                self._m_packet_combined.inc()
            self._m_msg_sent.inc(count)

    def _encode_packets_py(self, batch: list[tuple], ct: int):
        """Pure-Python fallback for the native packet builder; returns
        (frames, per-frame message counts)."""
        frames: list[bytes] = []
        counts: list[int] = []
        p = wire_pb2.Packet()
        size = 0
        for channel_id, broadcast, stub_id, msg_type, body in batch:
            entry = _entry_size(channel_id, broadcast, stub_id, msg_type, len(body))
            if entry > MAX_PACKET_SIZE:
                self.logger.warning("skipping oversized message (%d bytes)", entry)
                continue
            if p.messages and size + entry > MAX_PACKET_SIZE:
                frames.append(encode_frame(p.SerializeToString(), ct))
                counts.append(len(p.messages))
                p = wire_pb2.Packet()
                size = 0
            p.messages.add(
                channelId=channel_id, broadcast=broadcast, stubId=stub_id,
                msgType=msg_type, msgBody=body,
            )
            size += entry
        if p.messages:
            frames.append(encode_frame(p.SerializeToString(), ct))
            counts.append(len(p.messages))
        return frames, counts

    # ---- lifecycle -------------------------------------------------------

    def add_close_handler(self, handler: Callable[[], None]) -> None:
        self.close_handlers.append(handler)

    def close(self, unexpected: bool = False) -> None:
        """(ref: connection.go:351-380). ``unexpected=True`` marks an
        abnormal close, enabling recovery for recoverable server conns."""
        if self.is_closing():
            return
        # Deliver a still-deferred ingest run BEFORE teardown (advisor r5
        # medium): a client's final user-space burst can land in the same
        # event-loop batch as EOF (data_received then connection_lost
        # before the 1ms pump) — the previous synchronous dispatch and
        # the reference's sequential read loop both delivered it.
        if self._fast_run is not None:
            try:
                self.flush_ingest()
            except Exception:
                self.logger.exception("final ingest flush failed during close")
        if self._pending_msgs:
            # A congested stash gets one last dispatch attempt; whatever
            # the full channel still refuses dies with the conn — but
            # COUNTED (packet_dropped), never silently (the flush_ingest
            # above can also land here when the queue is full).
            try:
                self.flush_pending()
            except Exception:
                self.logger.exception("final stash flush failed during close")
            if self._pending_msgs:
                dropped = 0
                counted = set()
                for mp, drop_token, _stamp in self._pending_msgs:
                    if drop_token[0] or id(drop_token) in counted:
                        continue
                    counted.add(id(drop_token))
                    drop_token[0] = True
                    dropped += (mp.n_packets if type(mp) is _ForwardBatch
                                else 1)
                if dropped:
                    self._m_packet_dropped.inc(dropped)
                self._pending_msgs.clear()
        if self._is_packet_recording_enabled() and self.replay_session is not None:
            self.replay_session.persist(
                global_settings.replay_session_persistence_dir, self.id
            )
        for handler in self.close_handlers:
            try:
                handler()
            except Exception:
                self.logger.exception("close handler failed")
        if (
            unexpected
            and self.connection_type == ConnectionType.SERVER
            and global_settings.server_conn_recoverable
        ):
            from .connection_recovery import make_recoverable

            make_recoverable(self)
        self.state = ConnectionState.CLOSING
        global close_epoch
        close_epoch += 1  # channels' prune scans key off this
        try:
            self.transport.close()
        except Exception:
            pass
        self.send_queue.clear()
        # Normally already flushed above; a run that re-appeared (close
        # handler fed bytes) dies with the conn.
        self._fast_run = None
        self.envelope.queue_bytes = 0
        _edge.forget(self)
        _pending_ingest.discard(self)
        _stash_retry.pop(self, None)
        _all_connections.pop(self.id, None)
        from .ddos import untrack_unauthenticated

        untrack_unauthenticated(self.id)
        metrics.connection_num.labels(conn_type=self.connection_type.name).dec()
        self.logger.info("closed connection")

    def disconnect(self) -> None:
        """Graceful server-initiated disconnect (DisconnectMessage path)."""
        self.flush()

    def is_closing(self) -> bool:
        return self.state >= ConnectionState.CLOSING

    def on_authenticated(self, pit: str) -> None:
        """(ref: Connection.OnAuthenticated). Promotes the FSM past the
        auth state and, for recoverable PITs, starts recovery."""
        from .connection_recovery import get_recover_handle, recover_from_handle

        if self.state == ConnectionState.AUTHENTICATED:
            return
        self.state = ConnectionState.AUTHENTICATED
        self.pit = pit
        from .ddos import untrack_unauthenticated

        untrack_unauthenticated(self.id)
        if self.fsm is not None:
            self.fsm.move_to_next_state()
        handle = get_recover_handle(pit)
        if handle is not None and not handle.is_timed_out():
            recover_from_handle(self, handle)

    def should_recover(self) -> bool:
        return self.recover_handle is not None

    # ---- queries ---------------------------------------------------------

    def has_authority_over(self, ch) -> bool:
        """(ref: channel.go:540-549): global owner or channel owner."""
        from .channel import get_global_channel

        gch = get_global_channel()
        if gch is not None and gch.get_owner() is self:
            return True
        return ch.get_owner() is self

    def has_interest_in(self, spatial_ch_id: int) -> bool:
        return spatial_ch_id in self.spatial_subscriptions

    def remote_addr(self) -> Optional[tuple]:
        return self.transport.remote_addr()

    def remote_ip(self) -> Optional[str]:
        addr = self.remote_addr()
        return addr[0] if addr else None

    def _is_packet_recording_enabled(self) -> bool:
        return (
            self.connection_type == ConnectionType.CLIENT
            and global_settings.enable_record_packet
        )

    def __repr__(self) -> str:
        return f"Connection({self.connection_type.name} {self.id})"


# ---- registry ------------------------------------------------------------

_all_connections: dict[int, Connection] = {}
_next_connection_id = 0
# Connection ids promised to sessions that don't have a socket yet (a
# staged client redirect's recovery handle, federation/plane.py); the
# allocator must never hand one of these to a fresh connection.
_reserved_conn_ids: set[int] = set()
_server_fsm: Optional[MessageFsm] = None
_client_fsm: Optional[MessageFsm] = None


def init_connections(
    server_fsm_path: Optional[str] = None, client_fsm_path: Optional[str] = None
) -> None:
    """(ref: connection.go:116-155)."""
    global _server_fsm, _client_fsm
    if server_fsm_path:
        _server_fsm = MessageFsm.load(server_fsm_path)
    if client_fsm_path:
        _client_fsm = MessageFsm.load(client_fsm_path)
    from .message import init_message_map

    init_message_map()


def set_fsm_templates(server_fsm: Optional[MessageFsm], client_fsm: Optional[MessageFsm]) -> None:
    global _server_fsm, _client_fsm
    _server_fsm = server_fsm
    _client_fsm = client_fsm


def get_connection(conn_id: int) -> Optional[Connection]:
    conn = _all_connections.get(conn_id)
    if conn is None or conn.is_closing():
        return None
    return conn


def _generate_conn_id(transport: Transport, max_conn_id: int) -> int:
    """Dev: sequential. Prod: hash(addr) ^ time, less guessable
    (ref: connection.go:244-257)."""
    global _next_connection_id
    if global_settings.development:
        _next_connection_id += 1
        if _next_connection_id >= max_conn_id:
            raise RuntimeError("connection id space exhausted")
        return _next_connection_id
    addr = transport.remote_addr()
    h = hash_string(str(addr)) ^ int(time.time_ns() & 0xFFFFFFFF)
    return h & max_conn_id


def add_connection(transport: Transport, conn_type: ConnectionType) -> Connection:
    """(ref: connection.go:260-345). Banned IPs are refused at the accept
    point (ref: connection.go:228-235); at overload L3 a deep
    unauthenticated backlog refuses new CLIENT accepts outright (the
    polite ServerBusyMessage refusal happens at AUTH — this hard gate
    only protects the reactor floor from an accept storm that never
    reaches auth; doc/overload.md)."""
    from .ddos import is_ip_banned

    addr = transport.remote_addr()
    if addr is not None and is_ip_banned(addr[0]):
        get_logger("connection").info("refused connection of banned IP %s", addr[0])
        try:
            transport.close()
        except Exception:
            pass
        raise ConnectionRefusedError(f"banned IP {addr[0]}")
    if conn_type == ConnectionType.CLIENT:
        from .overload import governor

        if governor.level >= 3:
            from .ddos import _unauthenticated_connections

            if (len(_unauthenticated_connections)
                    > global_settings.overload_accept_headroom):
                governor.count_shed("admission_accept")
                try:
                    transport.close()
                except Exception:
                    pass
                raise ConnectionRefusedError("overload L3: accept refused")
    max_conn_id = (1 << global_settings.max_connection_id_bits) - 1
    conn_id = None
    for _ in range(100):
        candidate = _generate_conn_id(transport, max_conn_id)
        if candidate not in _all_connections and candidate not in _reserved_conn_ids:
            conn_id = candidate
            break
    if conn_id is None:
        raise RuntimeError("could not find a free connection id")

    if conn_type == ConnectionType.SERVER:
        fsm_template = _server_fsm
    elif conn_type == ConnectionType.CLIENT:
        fsm_template = _client_fsm
    else:
        raise ValueError(f"invalid connection type {conn_type}")
    fsm = fsm_template.clone() if fsm_template is not None else None

    conn = Connection(conn_id, conn_type, transport, fsm)
    _all_connections[conn_id] = conn
    from .ddos import track_unauthenticated

    track_unauthenticated(conn)
    metrics.connection_num.labels(conn_type=conn.connection_type.name).inc()
    return conn


def reserve_connection_id() -> int:
    """Allocate (and hold) a connection id with no live socket behind it
    — the id a staged recovery handle promises to a redirected client
    (core/connection_recovery.py stage_recovery_handle). Released when
    the client reclaims it through recovery, or explicitly via
    release_connection_id when the staging is torn down."""

    class _NoTransport:
        def remote_addr(self):
            return None

    max_conn_id = (1 << global_settings.max_connection_id_bits) - 1
    for _ in range(100):
        candidate = _generate_conn_id(_NoTransport(), max_conn_id)
        if candidate not in _all_connections and candidate not in _reserved_conn_ids:
            _reserved_conn_ids.add(candidate)
            return candidate
    raise RuntimeError("could not reserve a free connection id")


def release_connection_id(conn_id: int) -> None:
    _reserved_conn_ids.discard(conn_id)


def all_connections() -> dict[int, Connection]:
    return _all_connections


# Connections with queued output since the last pump cycle. The 1ms pump
# drains this set instead of scanning every connection (the reference
# pays one flush goroutine per connection instead; with thousands of
# mostly-idle connections the scan is the asyncio analog's hot spot).
_pending_flush: set["Connection"] = set()

# Connections holding a deferred fast-path ingest run (see flush_ingest).
_pending_ingest: set["Connection"] = set()

# Bumped on every connection close (and the test-hook reset): channels
# skip their per-tick subscriber prune scan while it is unchanged, so
# 10K mostly-healthy subscribers cost nothing per tick instead of a 10K
# is_closing() sweep at the tick rate.
close_epoch = 0


def drain_pending_flush() -> set["Connection"]:
    """Hand the pending set to the pump and start a fresh one."""
    global _pending_flush
    pending, _pending_flush = _pending_flush, set()
    return pending


def requeue_flush(conn: "Connection") -> None:
    """Put a connection back on the pump's pending set — the fairness
    carry-over path: a fair flush left entries queued, and they must go
    out next cycle without waiting for new sends."""
    _pending_flush.add(conn)


# Connections whose ingest dispatch stashed (queue full) from a pump- or
# tick-time flush, where no transport drain task exists to retry: the
# pump retries flush_pending until the stash drains (the transport-side
# _drain task covers the read-triggered case). A dict, not a set, so
# retries run in stash order (FIFO fairness, and deterministic tests).
_stash_retry: dict["Connection", None] = {}


def flush_pending_ingest() -> None:
    """Dispatch every deferred ingest run (1ms pump and channel ticks)."""
    global _pending_ingest
    if _stash_retry:
        # Channels observed full this cycle: conns whose stash head
        # targets one are skipped without re-attempting (a 10K-conn
        # backlog must not eat the tick budget re-failing), but conns
        # blocked on a DIFFERENT, drained channel still flush now
        # (advisor r5 low: the old break delayed them a full cycle).
        stash_start = _trace.now()
        full_channels: set[int] = set()
        for conn in list(_stash_retry):
            if conn.is_closing():
                _stash_retry.pop(conn, None)
                continue
            head = conn.pending_head_channel()
            if head is not None and head in full_channels:
                continue  # known-full target; retry next cycle
            if conn.flush_pending():
                _stash_retry.pop(conn, None)
            else:
                blocked = conn.pending_head_channel()
                if blocked is not None:
                    full_channels.add(blocked)
        _trace.stage("stash_retry", stash_start)
    if not _pending_ingest:
        return
    pending, _pending_ingest = _pending_ingest, set()
    ingest_start = _trace.now()
    for conn in pending:
        if not conn.is_closing():
            conn.flush_ingest()
            if conn.has_pending():
                _stash_retry[conn] = None
    # One stage span per drain cycle, never per read: the per-read cost
    # is what ROADMAP item 2 is about, and the whole point of the
    # deferred run is that N reads share this ONE dispatch.
    _trace.stage("ingest", ingest_start)


def flush_all() -> None:
    for conn in list(_all_connections.values()):
        if not conn.is_closing():
            conn.flush()


def reset_connections() -> None:
    """Test hook."""
    global _next_connection_id, close_epoch
    close_epoch += 1
    for conn in list(_all_connections.values()):
        conn.state = ConnectionState.CLOSING
    _all_connections.clear()
    _pending_flush.clear()
    _pending_ingest.clear()
    _stash_retry.clear()
    _reserved_conn_ids.clear()
    _next_connection_id = 0
    _edge.reset_edge()
