"""KCP wire-protocol transport (interop-class with the reference's kcp-go
listener, ref: pkg/channeld/connection.go:207-216).

Implements the KCP segment format and ARQ semantics so that a peer
speaking KCP (e.g. kcp-go with no FEC and no block crypt, the reference's
configuration) can interoperate at the wire level:

    0               4   5   6       8 (little-endian)
    +---------------+---+---+-------+
    |     conv      |cmd|frg|  wnd  |
    +---------------+---+---+-------+ 8
    |      ts       |      sn       |
    +---------------+---------------+ 16
    |      una      |      len      |
    +---------------+---------------+ 24
    |            data (len)         |

Commands: 81 PUSH (data), 82 ACK, 83 WASK (window probe), 84 WINS
(window answer). Multiple segments may be packed per datagram. ``una``
on every segment cumulatively acknowledges all sn < una; ACK segments
additionally ack one exact sn and echo its ts for RTT estimation.

Semantics implemented: send/receive windows, cumulative (una) + selective
(ACK) acknowledgement, RTO with kcp's x1.5 backoff, fast retransmit after
3 duplicate ack spans, zero-window probing (WASK/WINS), dead-link
detection, and in-order stream delivery. ``frg`` is always 0 on send
(stream mode) — the byte stream carries this package's 5-byte-tag
framing, so message boundaries live a layer up, exactly like the TCP
path; fragmented peer messages (frg>0) still reassemble correctly
because delivery concatenates payloads in sn order.

Deviations that do NOT affect the wire format: congestion control is
plain windowing (kcp-go ships with congestion control off for games:
nocwnd), and RTO bounds are tuned for interactive traffic.
"""

from __future__ import annotations

import asyncio
import secrets
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional

from ..chaos.injector import chaos as _chaos
from ..utils.logger import get_logger

logger = get_logger("kcp")

# conv, cmd, frg, wnd, ts, sn, una, len — the canonical 24-byte header.
_HEADER = struct.Struct("<IBBHIIII")
HEADER_SIZE = _HEADER.size
assert HEADER_SIZE == 24

CMD_PUSH = 81
CMD_ACK = 82
CMD_WASK = 83
CMD_WINS = 84
_VALID_CMDS = (CMD_PUSH, CMD_ACK, CMD_WASK, CMD_WINS)

MTU = 1400
SEG_PAYLOAD = MTU - HEADER_SIZE

RCV_WND = 256  # segments
SND_WND = 256
DEFAULT_RMT_WND = 32  # until the peer advertises (kcp IKCP_WND_RCV)

RTO_MIN = 0.03
RTO_DEF = 0.2
RTO_MAX = 6.0
DEAD_LINK = 20  # retransmissions of one segment before declaring the peer dead
FASTACK_RESEND = 3
PROBE_INTERVAL = 0.5  # zero-window probe cadence
MAX_QUEUE_BYTES = 1 << 20  # pending bytes before shedding a black-holed peer


def parse_segments(data: bytes) -> Iterator[tuple]:
    """Yield (conv, cmd, frg, wnd, ts, sn, una, payload) per packed
    segment; stops at the first truncated/hostile segment."""
    pos = 0
    n = len(data)
    while n - pos >= HEADER_SIZE:
        conv, cmd, frg, wnd, ts, sn, una, length = _HEADER.unpack_from(data, pos)
        pos += HEADER_SIZE
        if cmd not in _VALID_CMDS or length > n - pos:
            return
        yield conv, cmd, frg, wnd, ts, sn, una, data[pos : pos + length]
        pos += length


class _SndSeg:
    __slots__ = ("sn", "data", "ts", "rto", "resend_at", "xmit", "fastack")

    def __init__(self, sn: int, data: bytes):
        self.sn = sn
        self.data = data
        self.ts = 0
        self.rto = RTO_DEF
        self.resend_at = 0.0
        self.xmit = 0
        self.fastack = 0


class KcpConn:
    """One KCP conversation (either side). Byte-stream in, byte-stream
    out; datagrams via the ``output`` callback."""

    def __init__(self, conv: int, output: Callable[[bytes], None]):
        self.conv = conv
        self._output = output
        self._lock = threading.Lock()
        self._start = time.monotonic()

        # send side
        self.snd_una = 0  # oldest unacked sn
        self.snd_nxt = 0  # next sn to assign
        self._snd_buf: dict[int, _SndSeg] = {}  # in flight
        self._snd_queue: deque[bytes] = deque()  # awaiting window
        self._queue_bytes = 0
        self.rmt_wnd = DEFAULT_RMT_WND

        # receive side
        self.rcv_nxt = 0
        self._rcv_buf: dict[int, bytes] = {}
        self._acklist: list[tuple[int, int]] = []  # (sn, ts echo)

        # rtt estimation
        self._srtt = 0.0
        self._rttvar = 0.0
        self.rto = RTO_DEF

        # zero-window probing
        self._probe_wask_at = 0.0
        self._send_wins = False

        self.closed = False
        self.shed = False
        self.paused = False  # receiver backpressure: hold delivery
        self._chaos_held: list[bytes] = []  # reorder-fault holding pen
        self.on_stream: Optional[Callable[[bytes], None]] = None
        self.on_close: Optional[Callable[[], None]] = None

    def _now_ms(self) -> int:
        return int((time.monotonic() - self._start) * 1000) & 0xFFFFFFFF

    # -- sending ----------------------------------------------------------

    def send_stream(self, data: bytes) -> None:
        if self.closed or self.shed:
            return
        with self._lock:
            for off in range(0, len(data), SEG_PAYLOAD):
                seg = data[off : off + SEG_PAYLOAD]
                self._snd_queue.append(seg)
                self._queue_bytes += len(seg)
            overflow = self._queue_bytes > MAX_QUEUE_BYTES
        if overflow:
            self.shed = True
            logger.warning("kcp conv %d: send queue overflow, shedding peer",
                           self.conv)
            self._close()
            return
        self.flush()

    def _wnd_unused(self) -> int:
        return max(RCV_WND - len(self._rcv_buf), 0)

    def _pack(self, cmd: int, ts: int, sn: int, payload: bytes = b"") -> bytes:
        return _HEADER.pack(self.conv, cmd, 0, self._wnd_unused(), ts, sn,
                            self.rcv_nxt, len(payload)) + payload

    def flush(self) -> None:
        """Emit pending acks, probes, window-permitted queued segments, and
        due retransmissions, coalesced into MTU-bounded datagrams."""
        if self.closed:
            return
        now = time.monotonic()
        now_ms = self._now_ms()
        out: list[bytes] = []
        dead = False
        with self._lock:
            # Acks first (kcp flushes acks before data).
            for sn, ts in self._acklist:
                out.append(self._pack(CMD_ACK, ts, sn))
            self._acklist.clear()

            # Window management.
            if self.rmt_wnd == 0 and now >= self._probe_wask_at:
                out.append(self._pack(CMD_WASK, now_ms, 0))
                self._probe_wask_at = now + PROBE_INTERVAL
            if self._send_wins:
                out.append(self._pack(CMD_WINS, now_ms, 0))
                self._send_wins = False

            # Queue -> flight while the effective window allows.
            cwnd = min(SND_WND, max(self.rmt_wnd, 0))
            while self._snd_queue and self.snd_nxt < self.snd_una + cwnd:
                data = self._snd_queue.popleft()
                self._queue_bytes -= len(data)
                seg = _SndSeg(self.snd_nxt, data)
                seg.ts = now_ms
                seg.rto = self.rto
                seg.resend_at = now + seg.rto
                seg.xmit = 1
                self._snd_buf[seg.sn] = seg
                self.snd_nxt += 1
                out.append(self._pack(CMD_PUSH, seg.ts, seg.sn, seg.data))

            # Retransmissions: timeout or fast-ack threshold.
            for seg in self._snd_buf.values():
                need = False
                if now >= seg.resend_at:
                    need = True
                    seg.rto = min(seg.rto * 1.5, RTO_MAX)  # kcp backoff
                elif seg.fastack >= FASTACK_RESEND:
                    need = True
                    seg.fastack = 0
                if need:
                    seg.xmit += 1
                    seg.ts = now_ms
                    seg.resend_at = now + seg.rto
                    out.append(self._pack(CMD_PUSH, seg.ts, seg.sn, seg.data))
                    if seg.xmit >= DEAD_LINK:
                        dead = True
        self._emit(out)
        if dead and not self.closed:
            logger.warning("kcp conv %d: dead link", self.conv)
            self._close()

    def _emit(self, segments: list[bytes]) -> None:
        if not segments:
            return
        buf = bytearray()
        for seg in segments:
            if buf and len(buf) + len(seg) > MTU:
                self._send_datagram(bytes(buf))
                buf.clear()
            buf.extend(seg)
        if buf:
            self._send_datagram(bytes(buf))

    def _send_datagram(self, datagram: bytes) -> None:
        """Datagram egress, with the chaos loss/reorder/dup gate in front
        — the faults the ARQ exists to absorb. A held (reordered)
        datagram flushes after the next one; if traffic stops, the RTO
        retransmission regenerates it, so holding is equivalent to loss."""
        if _chaos.armed:
            if _chaos.fire("kcp.loss"):
                return
            if _chaos.fire("kcp.dup"):
                self._output(datagram)
            if _chaos.fire("kcp.reorder"):
                self._chaos_held.append(datagram)
                return
        self._output(datagram)
        if self._chaos_held:
            held, self._chaos_held = self._chaos_held, []
            for h in held:
                self._output(h)

    # -- receiving --------------------------------------------------------

    def input(self, data: bytes) -> None:
        """Feed one received datagram (possibly several packed segments)."""
        if self.closed:
            return
        # Validate conv across the WHOLE datagram before touching any
        # state: a mid-datagram conv mismatch must drop the datagram
        # wholesale, not strand payloads that earlier iterations already
        # dequeued (rcv_nxt would advance past them, so retransmits
        # arrive as duplicates and the bytes are lost forever).
        segments = list(parse_segments(data))
        if any(seg[0] != self.conv for seg in segments):
            return  # whole datagram suspect; no state applied
        deliver: list[bytes] = []
        with self._lock:
            for conv, cmd, frg, wnd, ts, sn, una, payload in segments:
                self.rmt_wnd = wnd
                # Cumulative ack: everything below una is delivered.
                if una > self.snd_una:
                    for s in [s for s in self._snd_buf if s < una]:
                        del self._snd_buf[s]
                    self.snd_una = una
                if cmd == CMD_ACK:
                    seg = self._snd_buf.pop(sn, None)
                    if seg is not None and seg.xmit == 1:
                        # RTT sample only from unretransmitted segments
                        # (Karn's rule; retransmitted echoes are ambiguous).
                        self._update_rtt((self._now_ms() - ts) & 0xFFFFFFFF)
                    # Fast-retransmit accounting: older in-flight segments
                    # skipped by this ack accumulate a span count.
                    for s, fseg in self._snd_buf.items():
                        if s < sn:
                            fseg.fastack += 1
                    while self.snd_una not in self._snd_buf and \
                            self.snd_una < self.snd_nxt:
                        self.snd_una += 1
                elif cmd == CMD_PUSH:
                    if sn < self.rcv_nxt + RCV_WND:
                        # Ack in-window and already-delivered (duplicate)
                        # segments so lost acks recover. Never ack ABOVE
                        # the window: the segment is dropped here, and an
                        # acked-but-dropped segment would leave the sender
                        # believing it delivered — a permanent stream gap.
                        self._acklist.append((sn, ts))
                    if self.rcv_nxt <= sn < self.rcv_nxt + RCV_WND:
                        self._rcv_buf.setdefault(sn, payload)
                        self._collect_deliverable(deliver)
                elif cmd == CMD_WASK:
                    self._send_wins = True
                # CMD_WINS carries the window in wnd — already applied.
        for chunk in deliver:
            if self.on_stream is not None:
                self.on_stream(chunk)
        self.flush()

    def _collect_deliverable(self, deliver: list[bytes]) -> None:
        while not self.paused and self.rcv_nxt in self._rcv_buf:
            deliver.append(self._rcv_buf.pop(self.rcv_nxt))
            self.rcv_nxt = (self.rcv_nxt + 1) & 0xFFFFFFFF

    def keepalive(self) -> None:
        """Emit a lone WASK probe. Costs one 24-byte datagram; the server
        counts it as inbound traffic, so a quiet-but-alive client is not
        idle-reaped (after which its mid-stream sn>0 PUSHes would be
        silently dropped — a new session requires PUSH sn 0)."""
        if self.closed:
            return
        with self._lock:
            seg = self._pack(CMD_WASK, self._now_ms(), 0)
        self._emit([seg])

    # -- backpressure ------------------------------------------------------

    def pause(self) -> None:
        """Stop delivering; buffered segments stay in rcv_buf and the
        advertised window shrinks, stalling the peer (KCP-native
        backpressure — the analog of not reading a TCP socket)."""
        self.paused = True

    def resume(self) -> None:
        self.paused = False
        deliver: list[bytes] = []
        with self._lock:
            self._collect_deliverable(deliver)
        for chunk in deliver:
            if self.on_stream is not None:
                self.on_stream(chunk)
        self.flush()  # re-advertise the opened window

    # -- rtt ---------------------------------------------------------------

    def _update_rtt(self, rtt_ms: int) -> None:
        rtt = rtt_ms / 1000.0
        if rtt < 0 or rtt > 60:
            return
        if self._srtt == 0:
            self._srtt = rtt
            self._rttvar = rtt / 2
        else:
            delta = abs(rtt - self._srtt)
            self._rttvar = 0.75 * self._rttvar + 0.25 * delta
            self._srtt = 0.875 * self._srtt + 0.125 * rtt
        self.rto = min(max(RTO_MIN, self._srtt + max(0.01, 4 * self._rttvar)),
                       RTO_MAX)

    # -- lifecycle ---------------------------------------------------------

    def _close(self) -> None:
        self.closed = True
        if self.on_close is not None:
            self.on_close()

    def close(self) -> None:
        self.closed = True


IDLE_TIMEOUT = 30.0  # reap sessions with no inbound traffic (dead peers)
KEEPALIVE_INTERVAL = 10.0  # client probes well inside IDLE_TIMEOUT
MAX_SESSIONS = 4096  # spoofed-source flood ceiling


class KcpServerProtocol(asyncio.DatagramProtocol):
    """Server side. Sessions are keyed by source address (kcp-go listener
    semantics): the first datagram from a new address creates the session
    with that datagram's conv; later datagrams must match both the address
    and the conv.

    Flood guards on top of the kcp-go model (KCP has no handshake, so a
    single datagram can otherwise allocate state): a new session requires
    a PUSH for sn 0 (every legitimate conversation's first emission), the
    session table is capped, and idle sessions are reaped — on top of the
    gateway's own unauth-connection reaper (core/ddos.py)."""

    def __init__(self, on_session: Callable[[KcpConn, tuple], None]):
        self.on_session = on_session
        self.transport: Optional[asyncio.DatagramTransport] = None
        self.sessions: dict[tuple, KcpConn] = {}
        self._last_input: dict[tuple, float] = {}
        self._update_task: Optional[asyncio.Task] = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        self._update_task = asyncio.ensure_future(self._update_loop())

    async def _update_loop(self) -> None:
        while True:
            now = time.monotonic()
            for addr, sess in list(self.sessions.items()):
                if sess.closed:
                    self._remove(addr)
                    continue
                if now - self._last_input.get(addr, now) > IDLE_TIMEOUT:
                    sess._close()  # fires on_close -> gateway conn close
                    self._remove(addr)
                    continue
                sess.flush()
            await asyncio.sleep(0.01)

    def _remove(self, addr) -> None:
        self.sessions.pop(addr, None)
        self._last_input.pop(addr, None)

    def datagram_received(self, data: bytes, addr) -> None:
        sess = self.sessions.get(addr)
        if sess is None:
            if len(self.sessions) >= MAX_SESSIONS:
                return
            first = next(parse_segments(data), None)
            # Only a PUSH for sn 0 opens a conversation: all other
            # well-formed segments (random cmd bytes, mid-stream sn,
            # probes) are dropped instead of allocating session +
            # gateway-connection state.
            if first is None or first[1] != CMD_PUSH or first[5] != 0:
                return
            conv = first[0]
            sess = KcpConn(conv,
                           lambda d, a=addr: self.transport.sendto(d, a))
            self.sessions[addr] = sess
            self.on_session(sess, addr)
        self._last_input[addr] = time.monotonic()
        sess.input(data)
        if sess.closed:
            self._remove(addr)

    def close(self) -> None:
        if self._update_task is not None:
            self._update_task.cancel()
        if self.transport is not None:
            self.transport.close()


class KcpClient:
    """Blocking client conversation (used by the client SDK). Picks a
    random conv like kcp-go's DialWithOptions."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.connect((host, port))
        self._sock.settimeout(timeout)
        self.conv = secrets.randbits(32) or 1
        self._last_tx = time.monotonic()
        self.session = KcpConn(self.conv, self._tx)
        self._recv_buffer = bytearray()
        self._recv_lock = threading.Lock()
        self.session.on_stream = self._on_stream

    def _tx(self, data: bytes) -> None:
        self._last_tx = time.monotonic()
        self._sock.send(data)

    def _on_stream(self, seg: bytes) -> None:
        with self._recv_lock:
            self._recv_buffer.extend(seg)

    def send(self, data: bytes) -> None:
        try:
            self.session.send_stream(data)
        except OSError:
            self.session.closed = True

    def _maybe_keepalive(self) -> None:
        if time.monotonic() - self._last_tx > KEEPALIVE_INTERVAL:
            self.session.keepalive()

    def recv(self, timeout: float = 0.0) -> bytes:
        deadline = time.monotonic() + max(timeout, 0.0)
        try:
            # Wait for the first datagram in keepalive-bounded slices: a
            # single long quiet recv() must not outlast the server's
            # idle reaper (IDLE_TIMEOUT) just because the probe check
            # only ran between calls.
            while True:
                self._maybe_keepalive()
                now = time.monotonic()
                wait = min(max(deadline - now, 0.0),
                           max(self._last_tx + KEEPALIVE_INTERVAL - now,
                               0.05))
                self._sock.settimeout(wait if wait > 0 else 0.000001)
                try:
                    data = self._sock.recv(65536)
                    break
                except socket.timeout:
                    if time.monotonic() >= deadline:
                        raise
            self.session.input(data)
            # Drain whatever else is queued without blocking.
            self._sock.settimeout(0.000001)
            while True:
                self.session.input(self._sock.recv(65536))
        except (socket.timeout, BlockingIOError):
            pass
        except OSError:
            self.session.closed = True
            return b""
        try:
            self.session.flush()
            self._maybe_keepalive()
        except OSError:
            self.session.closed = True
        with self._recv_lock:
            out = bytes(self._recv_buffer)
            self._recv_buffer.clear()
        return out

    def close(self) -> None:
        self.session.close()
        self._sock.close()
