"""Adversarial edge plane: per-connection resource envelopes,
slow-consumer quarantine, and edge-deadline reaping (doc/edge_hardening.md).

Every robustness plane before this one (chaos -> overload -> failover ->
device guard -> WAL) hardens the gateway against infrastructure failure
while assuming each socket speaks the protocol and drains its reads. At
10K+ connections some fraction is always broken, stalled, or hostile
(ref: the reference ships anti-DDoS as a first-class pillar), so this
plane bounds the damage any single peer can do, by construction:

- **Egress envelope**: each connection's send queue is bounded in
  entries AND bytes. Past either cap the oldest entries are dropped
  (counted) and every SHED-eligible subscription is marked for a
  full-state resync, so a bounded queue degrades to a coarser cadence,
  never to silent state loss.
- **Slow-consumer ladder**: a queue held above the high watermark for
  the grace window is cleared once (drop-to-full-resync); a peer that
  refills and holds again while still on probation is quarantined, and
  quarantine ends in a structured disconnect after its own grace.
- **Ingress caps**: a per-connection frames/s token bucket; sustained
  violation quarantines the peer (frame-SIZE bounds are the framing
  layer's MAX_PACKET_SIZE, counted here as malformed frames).
- **Auth-window reaping** lives in core/ddos.py (check_unauth_conns_once)
  and counts through this module's ledgers.

The plane is PER-PEER by design: quarantine never sheds load for anyone
but the offender. Global, load-driven degradation stays with the
overload ladder (core/overload.py) — the edge plane only FEEDS it a
pressure component (suspect + quarantined population), so a fleet-wide
slow-consumer event can still escalate the global ladder.

Thread model: every function here runs on the event-loop thread (ticked
from the 1ms flush pump, called from connection dispatch); there are no
locks and no threads.

Double-entry accounting: every counter increment goes through an
``EdgeLedgers.count_*`` method that bumps the python ledger and the
prometheus counter in the same call (the pattern
``OverloadGovernor.count_shed`` established); the abuse soak asserts
ledger == metric on a live gateway.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Optional

from ..utils.logger import get_logger
from . import metrics
from .settings import global_settings
from .types import MessageType

if TYPE_CHECKING:  # pragma: no cover
    from .connection import Connection

logger = get_logger("edge")

# Accounted overhead per send-queue entry beyond the body bytes: the
# protobuf field tags/length prefixes (<= ~30 bytes worst case) plus the
# tuple bookkeeping. A constant keeps the hot-path math to one add; the
# envelope is a resource bound, not wire accounting (bytes_sent is).
ENTRY_OVERHEAD = 24

# Consecutive over-rate reads before an ingress flood quarantines, and
# the calm window that forgives earlier strikes.
FLOOD_STRIKES = 3
FLOOD_FORGET_S = 2.0

# Probation after a drop-to-full-resync, in multiples of
# edge_slow_grace_s: a peer that re-enters the high watermark inside it
# escalates to quarantine; one that stays healthy is forgiven.
PROBATION_GRACE_MULT = 3.0


class EdgeLedgers:
    """Python-side ledgers for every edge counter (double-entry: the
    soak asserts these equal the prometheus samples exactly)."""

    def __init__(self) -> None:
        self.quarantine_counts: dict[str, int] = {}
        self.malformed_counts: dict[str, int] = {}
        self.egress_drop_counts: dict[str, int] = {}
        self.reap_counts: dict[str, int] = {}

    def count_quarantine(self, reason: str, n: int = 1) -> None:
        self.quarantine_counts[reason] = (
            self.quarantine_counts.get(reason, 0) + n
        )
        metrics.conn_quarantine.labels(reason=reason).inc(n)

    def count_malformed(self, stage: str, n: int = 1) -> None:
        self.malformed_counts[stage] = self.malformed_counts.get(stage, 0) + n
        metrics.malformed_frames.labels(stage=stage).inc(n)

    def count_egress_drop(self, reason: str, n: int = 1) -> None:
        self.egress_drop_counts[reason] = (
            self.egress_drop_counts.get(reason, 0) + n
        )
        metrics.egress_dropped.labels(reason=reason).inc(n)

    def count_reap(self, reason: str, n: int = 1) -> None:
        self.reap_counts[reason] = self.reap_counts.get(reason, 0) + n
        metrics.conn_reaped.labels(reason=reason).inc(n)


ledgers = EdgeLedgers()

# Slow-consumer suspects: connections at/above the high watermark, or on
# post-resync probation. dict for insertion-ordered, O(1) removal.
_suspects: dict["Connection", None] = {}
# Quarantined connections -> monotonic quarantine entry time.
_quarantined: dict["Connection", float] = {}


class ConnectionEnvelope:
    """Per-connection edge state: egress occupancy, slow-consumer ladder
    position, ingress token bucket. One per Connection, plain slots —
    this rides the per-message hot path."""

    __slots__ = (
        "queue_bytes", "high_since", "resynced", "probation_until",
        "quarantined", "tokens", "tokens_t", "flood_strikes",
        "last_violation",
    )

    def __init__(self) -> None:
        self.queue_bytes = 0
        # Monotonic time the queue crossed the high watermark; None
        # while below it.
        self.high_since: Optional[float] = None
        # A drop-to-full-resync already fired this episode; re-entering
        # the high watermark before probation_until escalates.
        self.resynced = False
        self.probation_until = 0.0
        self.quarantined = False
        # Ingress frames/s token bucket (burst = one second's allowance).
        self.tokens = 0.0
        self.tokens_t = 0.0
        self.flood_strikes = 0
        self.last_violation = 0.0

    def take_frames(self, n: int, now: float, rate: int) -> bool:
        """Charge ``n`` inbound frames against the bucket; False when
        the rate cap is exceeded (debt clamped to one burst so a single
        storm read cannot mute the bucket forever)."""
        if self.tokens_t == 0.0:
            self.tokens = float(rate)
        else:
            self.tokens = min(
                float(rate), self.tokens + (now - self.tokens_t) * rate
            )
        self.tokens_t = now
        self.tokens -= n
        if self.tokens >= 0.0:
            return True
        self.tokens = max(self.tokens, -float(rate))
        return False


def fill_fraction(conn: "Connection") -> float:
    """Egress occupancy as a fraction of the tighter cap."""
    st = global_settings
    env = conn.envelope
    return max(
        len(conn.send_queue) / max(st.edge_send_queue_max_msgs, 1),
        env.queue_bytes / max(st.edge_send_queue_max_bytes, 1),
    )


def note_egress(conn: "Connection") -> None:
    """Watermark + cap enforcement after an enqueue. Called by the
    sender on every queued message — the fast path is two compares."""
    st = global_settings
    env = conn.envelope
    over_msgs = len(conn.send_queue) > st.edge_send_queue_max_msgs
    over_bytes = env.queue_bytes > st.edge_send_queue_max_bytes
    if over_msgs or over_bytes:
        _trim_to_watermark(conn, "queue_msgs" if over_msgs else "queue_bytes")
    if env.high_since is None and fill_fraction(conn) >= st.edge_high_watermark:
        env.high_since = time.monotonic()
        _suspects[conn] = None


def note_drain(conn: "Connection") -> None:
    """Watermark exit after a flush actually drained the queue toward
    the transport (forced drops do NOT come here: clearing a stalled
    peer's queue is not evidence the peer recovered)."""
    env = conn.envelope
    if env.high_since is not None and (
        fill_fraction(conn) <= global_settings.edge_low_watermark
    ):
        env.high_since = None
        if not env.resynced:
            _suspects.pop(conn, None)


def _trim_to_watermark(conn: "Connection", reason: str) -> None:
    """Hard-cap breach: drop the OLDEST entries down to the high
    watermark (batch trim — amortized O(1) per enqueue for a stalled
    peer) and mark the connection for full-state resync; the dropped
    deltas are then reconstructed by the next due fan-out instead of
    being silently lost."""
    st = global_settings
    env = conn.envelope
    q = conn.send_queue
    target_msgs = int(st.edge_send_queue_max_msgs * st.edge_high_watermark)
    target_bytes = int(st.edge_send_queue_max_bytes * st.edge_high_watermark)
    dropped = 0
    qlen = len(q)
    while dropped < qlen and (
        qlen - dropped > target_msgs or env.queue_bytes > target_bytes
    ):
        env.queue_bytes -= len(q[dropped][4]) + ENTRY_OVERHEAD
        dropped += 1
    if dropped:
        del q[:dropped]
        ledgers.count_egress_drop(reason, dropped)
        mark_full_resync(conn)
        logger.warning(
            "%r egress envelope hit (%s): dropped %d oldest entries, "
            "marked full resync", conn, reason, dropped,
        )


def mark_full_resync(conn: "Connection") -> None:
    """Force the next due fan-out on every SHED-eligible subscription of
    ``conn`` to carry full state (core/data.py: had_first_fanout=False
    is the established full-state trigger). WRITE/SERVER subs (priority
    0) are exempt — authority traffic is never dropped, so it needs no
    resync and must not pay one."""
    from .channel import all_channels

    for ch in all_channels().values():
        cs = ch.subscribed_connections.get(conn)
        if cs is None or cs.priority < 1:
            continue
        foc = cs.fanout_conn
        if foc is not None:
            foc.had_first_fanout = False


def note_frames(conn: "Connection", n_frames: int) -> bool:
    """Ingress frame-rate enforcement for one read; False when the read
    pushed the peer into quarantine (the caller stops dispatching)."""
    st = global_settings
    rate = st.edge_max_frame_rate
    if rate <= 0:
        return True
    env = conn.envelope
    now = time.monotonic()
    if env.take_frames(n_frames, now, rate):
        if (env.flood_strikes
                and now - env.last_violation >= FLOOD_FORGET_S):
            env.flood_strikes = 0
        return True
    env.last_violation = now
    env.flood_strikes += 1
    if env.flood_strikes >= FLOOD_STRIKES:
        quarantine(conn, "ingress_flood")
        return False
    return True


def quarantine(conn: "Connection", reason: str) -> None:
    """Enter per-peer quarantine: egress frozen (queue discarded,
    counted), ingress discarded, structured disconnect after
    edge_quarantine_grace_s. Counted once per connection."""
    env = conn.envelope
    if env.quarantined or conn.is_closing():
        return
    env.quarantined = True
    env.high_since = None
    _suspects.pop(conn, None)
    _quarantined[conn] = time.monotonic()
    ledgers.count_quarantine(reason)
    metrics.conn_quarantined_num.set(len(_quarantined))
    n = len(conn.send_queue)
    if n:
        ledgers.count_egress_drop("quarantine", n)
        conn.send_queue.clear()
    env.queue_bytes = 0
    logger.warning("%r quarantined (%s); disconnect in %.1fs",
                   conn, reason, global_settings.edge_quarantine_grace_s)


def is_quarantined(conn: "Connection") -> bool:
    return conn.envelope.quarantined


def _structured_disconnect(conn: "Connection") -> None:
    """End a quarantine: one DisconnectMessage straight onto the wire
    (bypassing the frozen queue), then close. The peer learns it was
    disconnected on purpose — a silent RST looks like gateway failure
    and invites an immediate reconnect storm."""
    from ..protocol import control_pb2

    body = control_pb2.DisconnectMessage(connId=conn.id).SerializeToString()
    conn.send_queue.append(
        (0, 0, 0, int(MessageType.DISCONNECT), body)
    )
    try:
        conn.flush()
    except Exception:
        logger.exception("quarantine disconnect flush failed")
    ledgers.count_reap("quarantine")
    conn.close()


def edge_tick(now: Optional[float] = None) -> None:
    """Advance the slow-consumer ladder and the quarantine deadlines.
    Called from the 1ms flush pump; costs nothing while the suspect and
    quarantine sets are empty (the healthy steady state)."""
    if not global_settings.edge_enabled:
        return
    if not _suspects and not _quarantined:
        return
    if now is None:
        now = time.monotonic()
    st = global_settings
    for conn in list(_suspects):
        env = conn.envelope
        if conn.is_closing():
            _suspects.pop(conn, None)
            continue
        if env.high_since is None:
            # On probation (post-resync, currently under the watermark):
            # forgiven once the probation window passes quietly.
            if env.resynced and now >= env.probation_until:
                env.resynced = False
                _suspects.pop(conn, None)
            continue
        if now - env.high_since < st.edge_slow_grace_s:
            continue
        if env.resynced:
            # Second sustained-high episode inside probation: the peer
            # is not recovering — quarantine.
            quarantine(conn, "slow_consumer")
            continue
        # First offense: clear the queue (drop-to-full-resync) and start
        # probation. An honest-but-briefly-stalled reader recovers with
        # one coarse resync; a stalled one re-fills and escalates.
        n = len(conn.send_queue)
        if n:
            ledgers.count_egress_drop("slow_consumer", n)
            conn.send_queue.clear()
        env.queue_bytes = 0
        env.high_since = None
        env.resynced = True
        env.probation_until = now + st.edge_slow_grace_s * PROBATION_GRACE_MULT
        mark_full_resync(conn)
        logger.warning(
            "%r slow consumer: egress cleared to full resync "
            "(probation %.1fs)", conn, st.edge_slow_grace_s *
            PROBATION_GRACE_MULT,
        )
    for conn, since in list(_quarantined.items()):
        if conn.is_closing():
            _quarantined.pop(conn, None)
            metrics.conn_quarantined_num.set(len(_quarantined))
            continue
        if now - since >= st.edge_quarantine_grace_s:
            _quarantined.pop(conn, None)
            metrics.conn_quarantined_num.set(len(_quarantined))
            _structured_disconnect(conn)


def forget(conn: "Connection") -> None:
    """Connection teardown hook: drop any edge-plane registry entries."""
    _suspects.pop(conn, None)
    if _quarantined.pop(conn, None) is not None:
        metrics.conn_quarantined_num.set(len(_quarantined))


def pressure() -> float:
    """The governor's edge component: distressed-peer population against
    the same normalizer the ingest backlog uses (a fleet-wide
    slow-consumer event is gateway saturation even though each peer is
    handled per-peer)."""
    n = len(_suspects) + len(_quarantined)
    if not n:
        return 0.0
    return n / max(global_settings.overload_backlog_norm, 1)


def quarantined_count() -> int:
    return len(_quarantined)


def suspect_count() -> int:
    return len(_suspects)


def snapshot() -> dict:
    """Ledger + population snapshot (soak/ops surface)."""
    return {
        "quarantine_counts": dict(ledgers.quarantine_counts),
        "malformed_counts": dict(ledgers.malformed_counts),
        "egress_drop_counts": dict(ledgers.egress_drop_counts),
        "reap_counts": dict(ledgers.reap_counts),
        "suspects": len(_suspects),
        "quarantined": len(_quarantined),
    }


def reset_edge() -> None:
    """Test hook."""
    global ledgers
    ledgers = EdgeLedgers()
    _suspects.clear()
    _quarantined.clear()
    metrics.conn_quarantined_num.set(0)
