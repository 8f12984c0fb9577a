"""Reliable-UDP transport (the KCP-class transport, ref: connection.go's
kcp-go listener).

The reference offers TCP / KCP / WebSocket; KCP is reliable ARQ over UDP
tuned for latency. This module implements the same capability class with
a compact ARQ: conversation ids, sequence numbers, cumulative acks,
sliding-window retransmission with RTO backoff, and in-order delivery.
The byte stream it exposes carries the standard 5-byte-tag framing, so
the rest of the stack is transport-agnostic.

Datagram layout (little-endian):
    conv  u32   conversation id (0 in SYN until assigned)
    cmd   u8    1=DATA 2=ACK 3=SYN 4=SYN_ACK 5=FIN
    seq   u32   DATA: segment seq; SYN_ACK: assigned conv
    ack   u32   cumulative ack (next expected seq)
    payload     DATA only, <= MTU-13
"""

from __future__ import annotations

import asyncio
import secrets
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils.logger import get_logger

logger = get_logger("rudp")

_HEADER = struct.Struct("<IBII")
CMD_DATA, CMD_ACK, CMD_SYN, CMD_SYN_ACK, CMD_FIN = 1, 2, 3, 4, 5
MTU = 1200
SEG_PAYLOAD = MTU - _HEADER.size
DEFAULT_RTO = 0.1
MAX_RTO = 1.6
# Sliding windows, both directions. The send window bounds in-flight
# segments; overflow queues in a pending buffer whose byte size is capped —
# a black-holed peer therefore costs at most MAX_PENDING_BYTES + WINDOW
# datagrams before the session is shed. The receive window bounds the
# out-of-order reorder buffer so a peer cannot park segments at arbitrary
# far-future sequence numbers (kcp-go enforces the same with its wnd field).
WINDOW = 256
MAX_PENDING_BYTES = 1 << 20


class RudpSession:
    """One reliable conversation (either side)."""

    def __init__(self, conv: int, send_datagram: Callable[[bytes], None]):
        self.conv = conv
        self._send_datagram = send_datagram
        self._lock = threading.Lock()
        # send state
        self._next_seq = 0
        self._unacked: dict[int, tuple[bytes, float, float]] = {}  # seq -> (dgram, sent_at, rto)
        self._pending: deque[tuple[int, bytes]] = deque()  # (seq, payload) awaiting window
        self._pending_bytes = 0
        self.shed = False  # peer stopped acking and the pending cap overflowed
        # receive state
        self._expected = 0
        self._reorder: dict[int, bytes] = {}
        self.on_stream: Optional[Callable[[bytes], None]] = None
        self.on_close: Optional[Callable[[], None]] = None
        self.closed = False
        self._dropped_unacked = False

    def drop_unacked(self) -> None:
        """Called by a consumer from inside on_stream to refuse the segment
        (backpressure): it stays un-acked and is retried by the peer."""
        self._dropped_unacked = True

    # -- sending ----------------------------------------------------------

    def send_stream(self, data: bytes) -> None:
        """Segment a stream chunk into DATA datagrams, respecting the send
        window: at most WINDOW segments in flight; overflow queues until the
        peer acks, and a peer that never acks past MAX_PENDING_BYTES gets the
        session shed (the reliable-UDP analog of a TCP send-buffer timeout)."""
        if self.closed or self.shed:
            # A closed/shed session must not keep accumulating pending
            # segments (the cap below only fires once).
            return
        to_send: list[bytes] = []
        with self._lock:
            for off in range(0, len(data), SEG_PAYLOAD):
                seg = data[off : off + SEG_PAYLOAD]
                seq = self._next_seq
                self._next_seq += 1
                if len(self._unacked) < WINDOW and not self._pending:
                    dgram = _HEADER.pack(self.conv, CMD_DATA, seq,
                                         self._expected) + seg
                    self._unacked[seq] = (dgram, time.monotonic(), DEFAULT_RTO)
                    to_send.append(dgram)
                else:
                    self._pending.append((seq, seg))
                    self._pending_bytes += len(seg)
            overflow = self._pending_bytes > MAX_PENDING_BYTES
        for dgram in to_send:
            self._send_datagram(dgram)
        if overflow and not self.closed:
            self.shed = True
            logger.warning("rudp conv %d: send buffer overflow, shedding peer",
                           self.conv)
            self.fin()
            if self.on_close is not None:
                self.on_close()

    def _promote_pending_locked(self) -> list[bytes]:
        """Move queued segments into the open send window. Caller holds _lock."""
        out: list[bytes] = []
        while self._pending and len(self._unacked) < WINDOW:
            seq, seg = self._pending.popleft()
            self._pending_bytes -= len(seg)
            dgram = _HEADER.pack(self.conv, CMD_DATA, seq, self._expected) + seg
            self._unacked[seq] = (dgram, time.monotonic(), DEFAULT_RTO)
            out.append(dgram)
        return out

    def tick_retransmit(self) -> None:
        now = time.monotonic()
        with self._lock:
            to_send = []
            for seq, (dgram, sent_at, rto) in list(self._unacked.items()):
                if now - sent_at >= rto:
                    to_send.append(dgram)
                    self._unacked[seq] = (dgram, now, min(rto * 2, MAX_RTO))
            to_send.extend(self._promote_pending_locked())
        for dgram in to_send:
            self._send_datagram(dgram)

    # -- receiving --------------------------------------------------------

    def on_datagram(self, cmd: int, seq: int, ack: int, payload: bytes) -> None:
        with self._lock:
            # Cumulative ack clears everything below it and opens the window
            # for queued segments.
            for s in [s for s in self._unacked if s < ack]:
                del self._unacked[s]
            promoted = self._promote_pending_locked()
        for dgram in promoted:
            self._send_datagram(dgram)
        if cmd == CMD_ACK:
            return
        if cmd == CMD_FIN:
            self.closed = True
            if self.on_close is not None:
                self.on_close()
            return
        if cmd != CMD_DATA:
            return
        deliver: list[bytes] = []
        with self._lock:
            self._dropped_unacked = False
            if self._expected <= seq < self._expected + WINDOW:
                self._reorder[seq] = payload
                while self._expected in self._reorder:
                    nxt = self._reorder.pop(self._expected)
                    if self.on_stream is not None:
                        self.on_stream(nxt)
                        if self._dropped_unacked:
                            # Consumer refused the segment (backpressure):
                            # put it back and stop advancing; the un-acked
                            # window stalls the sender until we drain.
                            self._reorder[self._expected] = nxt
                            break
                    else:
                        deliver.append(nxt)
                    self._expected += 1
            # Ack what we have (cumulative), also re-acks duplicates.
            ack_dgram = _HEADER.pack(self.conv, CMD_ACK, 0, self._expected)
        self._send_datagram(ack_dgram)

    def fin(self) -> None:
        self.closed = True
        try:
            self._send_datagram(_HEADER.pack(self.conv, CMD_FIN, 0, self._expected))
        except OSError:
            pass


class RudpServerProtocol(asyncio.DatagramProtocol):
    """Server side: demux datagrams by conversation id; hand each new
    conversation to ``on_session(session, addr)``."""

    def __init__(self, on_session: Callable[[RudpSession, tuple], None]):
        self.on_session = on_session
        self.transport: Optional[asyncio.DatagramTransport] = None
        self.sessions: dict[int, RudpSession] = {}
        self._addr_of: dict[int, tuple] = {}
        self._conv_of_addr: dict[tuple, int] = {}
        self._retransmit_task: Optional[asyncio.Task] = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        self._retransmit_task = asyncio.ensure_future(self._retransmit_loop())

    async def _retransmit_loop(self) -> None:
        while True:
            for conv, session in list(self.sessions.items()):
                if session.closed:
                    # Shed / server-initiated closes never see another
                    # datagram from the peer, so reap here — otherwise the
                    # session maps leak and the dead peer's unacked window
                    # is retransmitted forever.
                    self._remove_session(conv)
                    continue
                session.tick_retransmit()
            await asyncio.sleep(0.02)

    def _remove_session(self, conv: int) -> None:
        self.sessions.pop(conv, None)
        addr = self._addr_of.pop(conv, None)
        if addr is not None and self._conv_of_addr.get(addr) == conv:
            del self._conv_of_addr[addr]

    def datagram_received(self, data: bytes, addr) -> None:
        if len(data) < _HEADER.size:
            return
        conv, cmd, seq, ack = _HEADER.unpack_from(data)
        payload = data[_HEADER.size :]
        if cmd == CMD_SYN:
            # A retransmitted SYN (lost SYN_ACK) must not create a second
            # conversation: re-ack the existing one for this address.
            existing = self._conv_of_addr.get(addr)
            if existing is not None and existing in self.sessions:
                if self.sessions[existing].closed:
                    # Stale session awaiting reap: let the peer start fresh.
                    self._remove_session(existing)
                else:
                    self.transport.sendto(
                        _HEADER.pack(existing, CMD_SYN_ACK, existing, 0), addr
                    )
                    return
            # Unguessable conversation ids: sequential ids let any remote
            # host address an established session (inject DATA / forge FIN).
            # kcp-go keys sessions by source address; we do both — random
            # conv plus the source-address check below.
            conv = secrets.randbits(32)
            while conv == 0 or conv in self.sessions:
                conv = secrets.randbits(32)
            session = RudpSession(
                conv, lambda d, a=addr: self.transport.sendto(d, a)
            )
            self.sessions[conv] = session
            self._addr_of[conv] = addr
            self._conv_of_addr[addr] = conv
            self.transport.sendto(_HEADER.pack(conv, CMD_SYN_ACK, conv, 0), addr)
            self.on_session(session, addr)
            return
        session = self.sessions.get(conv)
        if session is None:
            return
        if self._addr_of.get(conv) != addr:
            # Spoof guard: a datagram for an established conversation must
            # come from the address that opened it (kcp-go sessions are
            # likewise keyed by source address). Dropping, not rebinding —
            # rebinding would let an attacker steal the session.
            return
        session.on_datagram(cmd, seq, ack, payload)
        if session.closed:
            self._remove_session(conv)

    def close(self) -> None:
        if self._retransmit_task is not None:
            self._retransmit_task.cancel()
        if self.transport is not None:
            self.transport.close()


class RudpClient:
    """Blocking client conversation (used by the client SDK)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.connect((host, port))
        self._sock.settimeout(timeout)
        self.session: Optional[RudpSession] = None
        self._recv_buffer = bytearray()
        self._recv_lock = threading.Lock()
        # Handshake.
        self._sock.send(_HEADER.pack(0, CMD_SYN, 0, 0))
        end = time.monotonic() + timeout
        conv = None
        while time.monotonic() < end:
            try:
                data = self._sock.recv(65536)
            except socket.timeout:
                self._sock.send(_HEADER.pack(0, CMD_SYN, 0, 0))
                continue
            c, cmd, seq, ack = _HEADER.unpack_from(data)
            if cmd == CMD_SYN_ACK:
                conv = seq
                break
        if conv is None:
            raise TimeoutError("rudp handshake failed")
        self.session = RudpSession(conv, self._sock.send)
        self.session.on_stream = self._on_stream

    def _on_stream(self, seg: bytes) -> None:
        with self._recv_lock:
            self._recv_buffer.extend(seg)

    def send(self, data: bytes) -> None:
        self.session.send_stream(data)

    def recv(self, timeout: float = 0.0) -> bytes:
        """Pump the socket once; return whatever ordered bytes arrived."""
        self._sock.settimeout(timeout if timeout > 0 else 0.000001)
        try:
            while True:
                data = self._sock.recv(65536)
                if len(data) >= _HEADER.size:
                    conv, cmd, seq, ack, = _HEADER.unpack_from(data)
                    self.session.on_datagram(cmd, seq, ack, data[_HEADER.size:])
                self._sock.settimeout(0.000001)
        except (socket.timeout, BlockingIOError):
            pass
        except OSError:
            # ICMP unreachable etc.: the peer is gone.
            self.session.closed = True
            return b""
        try:
            self.session.tick_retransmit()
        except OSError:
            self.session.closed = True
        with self._recv_lock:
            out = bytes(self._recv_buffer)
            self._recv_buffer.clear()
        return out

    def close(self) -> None:
        if self.session is not None:
            self.session.fin()
        self._sock.close()
