"""Channel runtime: registry, id spaces, tick loop, broadcast.

Capability parity with the reference channel layer (ref: pkg/channeld/channel.go).
Where the reference runs a goroutine per channel, we run an asyncio task per
channel; all channel state is only touched from that task (or from the
synchronous ``tick_once`` used by tests with a synthetic clock), preserving
the reference's single-writer discipline without locks.

Id spaces (ref: settings.go:94-95, channel.go:218-253): GLOBAL = 0,
non-spatial 1..spatial_start-1, spatial spatial_start..entity_start-1,
entity channels use fixed id = entity_start + entityId.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, Optional

from ..chaos.injector import chaos as _chaos
from ..protocol import control_pb2
from ..utils.idalloc import IdAllocator
from ..utils.logger import get_logger
from . import events, metrics
from .data import ChannelData, FanOutConnection, tick_data
from .data import (
    reflect_channel_data_message,
    _channel_data_extension_registry,
    register_channel_data_type,
)
from .affinity import affinity as _affinity
from .overload import governor as _governor
from .settings import global_settings
from .slo import slo as _slo
from .tracing import recorder as _trace
from .wal import wal as _wal
from .types import BroadcastType, ChannelType, ConnectionType, GLOBAL_CHANNEL_ID, MessageType

logger = get_logger("channel")

# Hot-path handles bound lazily (circular imports).
_MessageContext = None
_connection_mod = None

# Channels whose in-queues are above the high watermark. A reactor pauses
# reading from a connection only while a channel *that connection* fed is
# congested — the asyncio analog of the reference's blocking
# `inMsgQueue <-` send, which paused exactly the sending connection's
# recv goroutine (ref: channel.go:295-310).
_congested_channels: set = set()
_drain_event: Optional[asyncio.Event] = None
QUEUE_CAPACITY = 4096
_HIGH_WATERMARK = QUEUE_CAPACITY * 3 // 4
_LOW_WATERMARK = QUEUE_CAPACITY // 4


def is_congested() -> bool:
    return bool(_congested_channels)


def connection_congested(conn) -> bool:
    """True while a channel this connection enqueued into is congested."""
    pending = getattr(conn, "backpressure_channels", None)
    if not pending:
        return False
    pending &= _congested_channels
    conn.backpressure_channels = pending
    return bool(pending)


def _signal_drain() -> None:
    if _drain_event is not None:
        _drain_event.set()


async def congestion_wait(conn) -> None:
    """Await until the channels ``conn`` fed drain below the low mark."""
    global _drain_event
    if _drain_event is None:
        _drain_event = asyncio.Event()
    while connection_congested(conn):
        _drain_event.clear()
        if not connection_congested(conn):
            break
        await _drain_event.wait()


class ChannelState(IntEnum):
    INIT = 0
    OPEN = 1
    HANDOVER = 2


class _MsgQueue(deque):
    """Deque with asyncio.Queue's non-blocking surface (qsize / empty /
    put_nowait / get_nowait) so call sites and tests keep reading the
    same way. Blocking gets were never used — the tick loop wakes via
    the channel's ``_wake`` event."""

    qsize = deque.__len__
    put_nowait = deque.append
    get_nowait = deque.popleft

    def empty(self) -> bool:
        return not self


@dataclass
class _QueuedMessage:
    ctx: "object"  # MessageContext; None for pure callables
    handler: Callable


class Channel:
    def __init__(self, channel_id: int, channel_type: int, owner=None):
        self.id = channel_id
        self.channel_type = ChannelType(channel_type)
        self.owner_connection = owner
        self.subscribed_connections: dict = {}  # conn -> ChannelSubscription
        self.metadata = ""
        self.data: Optional[ChannelData] = None
        self.latest_data_update_conn_id = 0
        self.spatial_notifier = None
        self.entity_controller = None
        # Unbounded deque with the asyncio.Queue method surface; the
        # external-put bound (QUEUE_CAPACITY) is enforced in _enqueue so
        # internal puts keep a reserve. A plain deque because nothing ever
        # awaits it (the tick loop wakes via _wake) and asyncio.Queue's
        # put/get bookkeeping was measurable at load-test rates.
        self.in_msg_queue: _MsgQueue = _MsgQueue()
        self.fan_out_queue: list[FanOutConnection] = []
        # Spatial channels with a TPU controller: engine sub-table slot ->
        # FanOutConnection, for consuming the batched device due mask;
        # subs without a device slot (table full / pre-engine) keep the
        # host time check via this side list — kept separately so the
        # device tick never rescans the whole fan-out queue.
        self.device_sub_slots: dict[int, FanOutConnection] = {}
        self.device_fallback_focs: list[FanOutConnection] = []
        self.start_ns = time.monotonic_ns()
        # connection.close_epoch at the last subscriber prune scan.
        self._seen_close_epoch = -1
        st = global_settings.get_channel_settings(self.channel_type)
        self.tick_interval = st.tick_interval_ms / 1000.0
        self.tick_frames = 0
        self.enable_client_broadcast = False
        self.removing = False
        self.recoverable_subs: dict = {}  # pit -> RecoverableSubscription
        self.logger = get_logger(f"channel.{self.channel_type.name}.{channel_id}")
        # Labels never change: resolve the histogram child once, not per
        # tick (same rationale as the per-connection metric children).
        self._m_tick_duration = metrics.channel_tick_duration.labels(
            channel_type=self.channel_type.name
        )
        self._tick_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._writer_task = None  # single-writer affinity (dev assertion)
        self.state = ChannelState.OPEN if self.has_owner() else ChannelState.INIT

    # ---- identity / time -------------------------------------------------

    def get_time(self) -> int:
        """Integer nanoseconds since channel creation (ref: ChannelTime)."""
        return time.monotonic_ns() - self.start_ns

    def is_removing(self) -> bool:
        return self.removing

    def __repr__(self) -> str:
        return f"Channel({self.channel_type.name} {self.id})"

    # ---- owner -----------------------------------------------------------

    def get_owner(self):
        return self.owner_connection

    def set_owner(self, conn) -> None:
        self.owner_connection = conn

    def has_owner(self) -> bool:
        conn = self.owner_connection
        return conn is not None and not conn.is_closing()

    def is_same_owner(self, other: "Channel") -> bool:
        conn = self.get_owner()
        return conn is not None and not conn.is_closing() and conn is other.get_owner()

    # ---- data ------------------------------------------------------------

    def init_data(
        self,
        data_msg,
        merge_options: Optional[control_pb2.ChannelDataMergeOptions] = None,
    ) -> None:
        """(ref: data.go:104-131)."""
        if data_msg is None:
            data_msg = reflect_channel_data_message(self.channel_type)
            if data_msg is None:
                self.logger.info(
                    "no channel data template registered; first update sets the data"
                )
        self.data = ChannelData(data_msg, merge_options,
                                channel_type=self.channel_type)
        initializer = getattr(data_msg, "init_data", None)
        if callable(initializer):
            initializer()
        factory = _channel_data_extension_registry.get(self.channel_type)
        if factory is not None:
            self.data.extension = factory()
            self.data.extension.init(self)
        if _wal.enabled:
            # Direct init_data callers (entity spawn paths, federation
            # adoption) bypass the message queue: mark here too.
            _wal.note_dirty(self.id)

    def get_data_message(self):
        return self.data.msg if self.data else None

    def set_data_update_conn_id(self, conn_id: int) -> None:
        self.latest_data_update_conn_id = conn_id

    # ---- message queue ---------------------------------------------------

    def put_message(self, msg, handler, conn, pack, raw_body=None,
                    external: bool = False, ingest_ns: int = 0) -> bool:
        """Enqueue from any task; handled in this channel's tick
        (ref: channel.go:295-310). ``raw_body`` carries the inbound bytes
        through for pure forwards so the send side need not re-encode.
        ``ingest_ns`` is the connection-read monotonic stamp the
        delivery-SLO plane threads through to the fan-out (core/slo.py;
        0 = internal/unstamped). False = queue full: NOT enqueued, NOT
        dropped — the caller must stash and retry after backpressure
        drains (connection.on_bytes does)."""
        if self.is_removing():
            return True  # channel dying: message vanishes, like the ref
        global _MessageContext
        if _MessageContext is None:  # late bind once (circular import)
            from .message import MessageContext as _MessageContext
        ctx = _MessageContext(
            msg_type=pack.msgType,
            msg=msg,
            connection=conn,
            channel=self,
            broadcast=pack.broadcast,
            stub_id=pack.stubId,
            channel_id=pack.channelId,
            arrival_time=self.get_time(),
            raw_body=raw_body,
            ingest_ns=ingest_ns,
        )
        return self._enqueue(_QueuedMessage(ctx, handler), external=external)

    def put_forward_batch(self, entries: list, conn,
                          ingest_ns: int = 0) -> bool:
        """Enqueue one batched-ingest run (pre-encoded owner send-queue
        entries from the native parse_forward path) as a single queue
        item. Semantics match N put_message calls whose handler is
        handle_client_to_server_user_message with broadcast=0: the owner
        resolves at tick time, mid-recovery owners drop, ownerless
        channels warn. False = queue full (caller stashes)."""
        if self.is_removing():
            return True  # channel dying: messages vanish, like the ref
        global _MessageContext
        if _MessageContext is None:
            from .message import MessageContext as _MessageContext
        ctx = _MessageContext(connection=conn, channel=self)
        return self._enqueue(
            _QueuedMessage(
                ctx, lambda _ctx, e=entries, t=ingest_ns:
                    self._deliver_forward_batch(e, t)
            ),
            external=True,
        )

    def _deliver_forward_batch(self, entries: list,
                               ingest_ns: int = 0) -> None:
        owner = self.get_owner()
        if owner is not None and not owner.is_closing():
            if owner.should_recover():
                # Owner mid-recovery: client updates are dropped
                # (ref: message.go:72-80).
                return
            owner.send_queue.extend(entries)
            global _connection_mod
            if _connection_mod is None:
                from . import connection as _connection_mod
            # Resolve the set through the module: drain_pending_flush
            # swaps in a fresh set every pump cycle.
            _connection_mod._pending_flush.add(owner)
            if _slo.enabled and ingest_ns:
                # The batched fast path's delivery point: the run just
                # landed on the owner's send queue (flushed this pump
                # cycle). Stamp carried from the OLDEST read folded in.
                _slo.record_delivery(self.channel_type.name, "fast",
                                     ingest_ns)
        else:
            # Every drop is counted (failover keys alerts off this);
            # the log stays rate-limited like the per-message path.
            metrics.ownerless_drops.labels(
                channel_type=self.channel_type.name
            ).inc(len(entries))
            now = time.monotonic()
            if now - getattr(self, "_ownerless_warn_at", 0.0) > 1.0:
                self._ownerless_warn_at = now
                self.logger.warning(
                    "channel has no owner to forward to (suppressing "
                    "repeats for 1s; %d batched messages dropped)",
                    len(entries),
                )

    def put_message_context(self, ctx, handler) -> None:
        if self.is_removing():
            return
        self._enqueue(_QueuedMessage(ctx, handler))

    def put_message_internal(self, msg_type: int, msg) -> None:
        """(ref: channel.go:319-339): sender = channel owner."""
        if self.is_removing():
            return
        from .message import MESSAGE_MAP, MessageContext

        entry = MESSAGE_MAP.get(msg_type)
        if entry is None:
            self.logger.error("no handler for message type %s", msg_type)
            return
        ctx = MessageContext(
            msg_type=msg_type,
            msg=msg,
            connection=self.get_owner(),
            channel=self,
            channel_id=self.id,
            arrival_time=self.get_time(),
        )
        self._enqueue(_QueuedMessage(ctx, entry.handler))

    def execute(self, callback: Callable[["Channel"], None]) -> None:
        """Run ``callback`` inside this channel's tick — the only safe way
        to touch channel state from outside (ref: channel.go:346-352)."""
        self._enqueue(_QueuedMessage(None, lambda _ctx: callback(self)))

    def _enqueue(self, qm: _QueuedMessage, external: bool = False) -> bool:
        """Enqueue for this channel's tick. External (connection-fed) puts
        are bounded at QUEUE_CAPACITY: a full queue returns False WITHOUT
        dropping — the connection stashes the message and its reads pause
        until the queue drains (the asyncio analog of the reference's
        blocking `inMsgQueue <-` send, channel.go:295-310; nothing is
        lost). Internal puts (execute callbacks, owner-side messages) ride
        a reserve above the cap: they are control-plane, self-limited, and
        dropping them would corrupt channel state."""
        size = len(self.in_msg_queue)
        if external and (
            size >= QUEUE_CAPACITY
            # Chaos: report the queue full without it being full — the
            # caller must take the same stash-don't-drop path it would
            # under a real overload (lifted when the next tick drains).
            or (_chaos.armed and _chaos.fire("connection.queue_full"))
        ):
            self._mark_congested(qm)
            return False
        self.in_msg_queue.append(qm)
        self._wake.set()
        if size + 1 >= _HIGH_WATERMARK:
            self._mark_congested(qm)
        return True

    def _mark_congested(self, qm: _QueuedMessage) -> None:
        _congested_channels.add(self.id)
        # Remember which connection fed the congested queue so only its
        # reads pause (None for internal puts).
        conn = getattr(qm.ctx, "connection", None) if qm.ctx else None
        if conn is not None:
            pending = getattr(conn, "backpressure_channels", None)
            if pending is None:
                pending = conn.backpressure_channels = set()
            pending.add(self.id)

    # ---- tick ------------------------------------------------------------

    def start_ticking(self) -> None:
        if self._tick_task is None:
            self._tick_task = asyncio.ensure_future(self._tick_loop())
            self._tick_task.add_done_callback(self._on_tick_task_done)

    def _on_tick_task_done(self, task: asyncio.Task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            self.logger.error("channel tick task died: %r", exc)

    def wake(self) -> None:
        """Wake a parked tick loop (new message, subscription, ...)."""
        self._wake.set()

    def _may_park(self) -> bool:
        if (
            self.subscribed_connections
            or self.recoverable_subs
            or not self.in_msg_queue.empty()
        ):
            return False
        if self.channel_type == ChannelType.GLOBAL:
            # The GLOBAL tick drives the spatial controller (handover
            # detection, server reaping): never park while one exists.
            from ..spatial.controller import get_spatial_controller

            if get_spatial_controller() is not None:
                return False
        return True

    async def _tick_loop(self) -> None:
        while not self.is_removing():
            tick_start = time.monotonic()
            # tick_once observes the duration histogram and feeds the
            # overload governor's budget accounting.
            self.tick_once(self.get_time(), tick_start)
            elapsed = time.monotonic() - tick_start
            if not self._may_park():
                await asyncio.sleep(max(self.tick_interval - elapsed, 0))
            else:
                # Idle channel: park until a message/subscription arrives
                # (or a coarse heartbeat) instead of spinning at the tick
                # cadence — 10K mostly-idle channels would otherwise wake
                # 500K times per second.
                self._wake.clear()
                if self.in_msg_queue.empty() and self._may_park():
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=0.5)
                    except asyncio.TimeoutError:
                        pass
                # Pace even after a wake so a message stream to an idle
                # channel can't drive ticks above 1/tick_interval.
                await asyncio.sleep(
                    max(self.tick_interval - (time.monotonic() - tick_start), 0)
                )

    def tick_once(self, now: Optional[int] = None, tick_start: Optional[float] = None) -> None:
        """One synchronous tick; ``now`` is channel time, injectable for
        tests (ref: channel.go:358-387)."""
        if global_settings.development:
            # Race detection (the analog of the reference's go test -race
            # discipline, SURVEY §5): channel state must only ever be
            # touched from one task — the one that ticks it.
            try:
                current = asyncio.current_task()
            except RuntimeError:
                current = None
            if current is not None:
                if self._writer_task is None:
                    self._writer_task = current
                elif self._writer_task is not current and not self._writer_task.done():
                    self.logger.error(
                        "single-writer violation: channel %d ticked from a "
                        "second task", self.id,
                    )
        if now is None:
            now = self.get_time()
        if tick_start is None:
            tick_start = time.monotonic()

        # Spatial controller ticks with the GLOBAL channel only, to keep a
        # single writer (ref: channel.go:366-369).
        if self.channel_type == ChannelType.GLOBAL:
            from ..spatial.controller import get_spatial_controller

            controller = get_spatial_controller()
            if controller is not None:
                controller.tick()

        self.tick_frames += 1
        if self.channel_type == ChannelType.GLOBAL:
            # The GLOBAL tick is the authoritative loop-thread anchor:
            # it (re)binds the tick-loop affinity domain every tick, so
            # every expect() downstream checks against THIS thread
            # (doc/concurrency.md; disarmed = one attribute load).
            _affinity.enter("tick-loop")
            # The GLOBAL tick is the recorder's clock: every span this
            # tick (any channel, any stage) is stamped with this number,
            # which is what lets a dump say "tick 8041 spent 9.3ms in
            # fan-out" instead of showing an anonymous timeline.
            _trace.set_tick(self.tick_frames)
        # Deferred ingest runs land in the queue before it drains, so a
        # tick never misses traffic the per-read dispatch would have
        # delivered (also what keeps on_bytes + tick_once tests exact).
        global _connection_mod
        if _connection_mod is None:
            from . import connection as _connection_mod
        _connection_mod.flush_pending_ingest()
        msg_start = time.monotonic_ns()
        had_msgs = bool(self.in_msg_queue)
        self._tick_messages(tick_start)
        if had_msgs:
            _trace.stage("messages", msg_start, lane=self.id)
            # WAL dirty mark (doc/persistence.md): every channel-data
            # mutation runs through this queue (update merges AND
            # execute closures), so a post-drain mark captures exactly
            # the channels whose state may have changed this tick. One
            # set-add; the GLOBAL tick coalesces the set into
            # channel_state records.
            if _wal.enabled and self.data is not None:
                _wal.note_dirty(self.id)
        fanout_start = time.monotonic()
        tick_data(self, now)
        if self.subscribed_connections:
            metrics.fanout_decision_latency.labels(backend="host").observe(
                time.monotonic() - fanout_start
            )
            _trace.stage("fanout", int(fanout_start * 1e9), lane=self.id)
        self._tick_connections()
        self._tick_recoverable_subscriptions()
        # Per-tick budget accounting: observed here (not in the async
        # loop) so synchronous tick_once drivers — tests, soak harnesses
        # — feed the histogram and the overload governor too. The GLOBAL
        # tick doubles as the governor's update cadence: it samples the
        # ingest backlog/stash signals and moves the degradation ladder
        # at most one step (doc/overload.md).
        elapsed = time.monotonic() - tick_start
        self._m_tick_duration.observe(elapsed)
        _governor.note_tick(elapsed, self.tick_interval)
        if _slo.enabled and self.tick_interval > 0:
            # Budget-utilization event for the tick_budget SLO (>1.0 ==
            # the tick overran its interval; core/slo.py).
            _slo.observe("tick_budget", elapsed / self.tick_interval)
        if self.channel_type == ChannelType.SPATIAL:
            # Per-server load attribution for the balancer: this cell's
            # tick cost lands on its owner server's pressure ledger.
            owner = self.owner_connection
            if owner is not None:
                _governor.note_server_cost(owner.id, elapsed)
        if self.channel_type == ChannelType.GLOBAL:
            gov_start = time.monotonic_ns()
            _governor.update(self.tick_interval)
            _trace.stage("overload", gov_start, lane=self.id)
            if _slo.enabled:
                # Burn-rate evaluation + the round-robin staleness
                # sample, inside the GLOBAL tick's single-writer
                # context (doc/observability.md).
                _slo.on_global_tick()
            if _wal.enabled:
                # Drain the dirty set into journal records — inside the
                # GLOBAL tick, the same single-writer context the epoch
                # replica packs cell state in. Enqueue-only: the fsync
                # lives on the WAL's writer thread.
                _wal.on_global_tick()
        if _trace.enabled:
            # The tick span closes HERE (after the governor update) so
            # the overload stage nests inside it — containment is how
            # dumps reconstruct nesting; `elapsed` keeps its historical
            # pre-governor window for the histogram/governor intake.
            total = time.monotonic() - tick_start
            _trace.span(
                f"tick.{self.channel_type.name}",
                int(tick_start * 1e9), lane=self.id,
            )
            if self.tick_interval > 0 and total > self.tick_interval:
                # A blown tick budget freezes the ring: the dump holds
                # the very stages that ate it (cooldown-bounded).
                _trace.note_anomaly(
                    "tick_budget",
                    f"{self.channel_type.name} {self.id}: "
                    f"{total * 1e3:.2f}ms > "
                    f"{self.tick_interval * 1e3:.0f}ms",
                )

    def _tick_messages(self, tick_start: float) -> None:
        """Drain the queue within the tick budget (ref: channel.go:389-412).

        The budget clock starts HERE, not at tick start: pre-message tick
        work (spatial controller, ingest flush) must not eat the message
        budget, or a full queue never drains below the congestion
        watermark and paused reads stay paused (r5 10K-conn livelock)."""
        tick_start = time.monotonic()
        try:
            queue = self.in_msg_queue
            while queue:
                qm = queue.popleft()
                # One bad message must never kill the channel task: isolate
                # every handler (internal puts may carry no connection —
                # e.g. RemoveChannel after owner loss — handlers guard
                # themselves).
                try:
                    qm.handler(qm.ctx)
                except Exception:
                    self.logger.exception(
                        "message handler failed (msgType=%s)",
                        getattr(qm.ctx, "msg_type", None),
                    )
                    continue
                if _chaos.armed:
                    # Chaos: a slow handler eats the tick budget; the
                    # budget break below must defer the tail (and the
                    # backpressure lift in finally must still run).
                    stall = _chaos.stall_s("channel.tick_budget")
                    if stall:
                        time.sleep(stall)  # tpulint: disable=async-blocking -- chaos-injected stall MODELS a slow handler eating the tick budget (doc/chaos.md); blocking is the point
                if qm.ctx is None:
                    continue
                if (
                    self.tick_interval > 0
                    and time.monotonic() - tick_start >= self.tick_interval
                ):
                    self.logger.warning(
                        "spent too long handling messages; %d deferred to next tick",
                        self.in_msg_queue.qsize(),
                    )
                    break
        finally:
            # Lift backpressure once the queue drained below the low mark.
            if (
                self.id in _congested_channels
                and self.in_msg_queue.qsize() <= _LOW_WATERMARK
            ):
                _congested_channels.discard(self.id)
                _signal_drain()

    def _tick_connections(self) -> None:
        """Prune closed subscribers; stash recoverable subs; handle owner
        loss (ref: channel.go:414-475). Skipped entirely while no
        connection anywhere has closed since this channel's last scan
        (closes bump connection.close_epoch): the scan is idempotent and
        a 10K-subscriber sweep at the tick rate was pure fixed cost."""
        global _connection_mod
        if _connection_mod is None:
            from . import connection as _connection_mod
        epoch = _connection_mod.close_epoch
        if epoch == self._seen_close_epoch:
            return
        self._seen_close_epoch = epoch
        from .message import MessageContext

        for conn in list(self.subscribed_connections.keys()):
            if not conn.is_closing():
                continue

            recover_handle = getattr(conn, "recover_handle", None)
            if recover_handle is not None:
                is_owner = self.get_owner() is conn
                sub = self.subscribed_connections.get(conn)
                if sub is not None:
                    from .connection_recovery import RecoverableSubscription

                    self.recoverable_subs[conn.pit] = RecoverableSubscription(
                        conn_handle=recover_handle,
                        is_owner=is_owner,
                        old_sub_time=time.time() - self.get_time() / 1e9 + sub.sub_time / 1e9,
                        old_sub_options=sub.options,
                    )
                if is_owner and global_settings.get_channel_settings(
                    self.channel_type
                ).send_owner_lost_and_recovered:
                    self.broadcast(
                        MessageContext(
                            msg_type=MessageType.CHANNEL_OWNER_LOST,
                            msg=control_pb2.ChannelOwnerLostMessage(),
                            broadcast=BroadcastType.ALL_BUT_OWNER,
                            channel_id=self.id,
                        )
                    )

            sub = self.subscribed_connections[conn]
            del self.subscribed_connections[conn]
            # Free the engine sub slot on the crash/drop path too (explicit
            # unsubscribe is not the only teardown) — idempotent with the
            # tick_data dead-conn sweep.
            from .subscription import release_device_fanout

            release_device_fanout(self, sub.fanout_conn)
            if self.get_owner() is conn:
                self.set_owner(None)
                if self.channel_type == ChannelType.GLOBAL:
                    events.global_channel_unpossessed.broadcast(self)
                if (
                    global_settings.get_channel_settings(
                        self.channel_type
                    ).remove_channel_after_owner_removed
                    and recover_handle is None
                ):
                    _remove_channel_after_owner_removed(self)
                    return
            else:
                owner = self.get_owner()
                if owner is not None:
                    from .subscription_messages import send_unsubscribed

                    send_unsubscribed(owner, self, conn, 0)

    def _tick_recoverable_subscriptions(self) -> None:
        from .connection_recovery import tick_recoverable_subscriptions

        tick_recoverable_subscriptions(self)

    # ---- broadcast -------------------------------------------------------

    def broadcast(self, ctx) -> None:
        """(ref: channel.go:495-520)."""
        bc = BroadcastType(ctx.broadcast)
        # One encode for the whole fleet (every recipient gets the same
        # bytes; the queued sender honors ctx.raw_body).
        ctx.ensure_raw_body()
        for conn in list(self.subscribed_connections.keys()):
            if conn is None:
                continue
            if bc.check(BroadcastType.ALL_BUT_SENDER) and conn is ctx.connection:
                continue
            if bc.check(BroadcastType.ALL_BUT_OWNER) and conn is self.get_owner():
                continue
            if (
                bc.check(BroadcastType.ALL_BUT_CLIENT)
                and conn.connection_type == ConnectionType.CLIENT
            ):
                continue
            if (
                bc.check(BroadcastType.ALL_BUT_SERVER)
                and conn.connection_type == ConnectionType.SERVER
            ):
                continue
            conn.send(ctx)

    def get_all_connections(self) -> set:
        return set(self.subscribed_connections.keys())

    def send_to_owner(self, ctx) -> bool:
        conn = self.get_owner()
        if conn is not None and not conn.is_closing():
            conn.send(ctx)
            return True
        return False

    def send_message_to_owner(self, msg_type: int, msg) -> bool:
        from .message import MessageContext

        return self.send_to_owner(
            MessageContext(msg_type=msg_type, msg=msg, channel_id=self.id)
        )

    def get_handover_entities(self, entity_id: int):
        from ..spatial.entity import get_handover_entities

        return get_handover_entities(self, entity_id)


# ---- registry -----------------------------------------------------------

_all_channels: dict[int, Channel] = {}
_global_channel: Optional[Channel] = None
_non_spatial_alloc: Optional[IdAllocator] = None
_spatial_alloc: Optional[IdAllocator] = None


class ChannelFullError(Exception):
    pass


def init_channels() -> None:
    """(ref: channel.go:118-150). Creates the GLOBAL channel and registers
    channel-data types named in the settings."""
    global _global_channel, _non_spatial_alloc, _spatial_alloc
    if _global_channel is not None:
        return
    # World boot doubles as the failover plane's install point: its
    # ServerLost listener must exist before any recoverable server can
    # die, and a fresh world starts with empty re-host/journal ledgers.
    from .failover import plane, reset_failover

    reset_failover()
    plane.install()
    # Same for the load balancer: fresh ledgers + the server-registration
    # orphan-adoption listener (doc/balancer.md).
    from ..spatial.balancer import balancer, reset_balancer

    reset_balancer()
    balancer.install()
    _non_spatial_alloc = IdAllocator(1, global_settings.spatial_channel_id_start - 1)
    _spatial_alloc = IdAllocator(
        global_settings.spatial_channel_id_start,
        global_settings.entity_channel_id_start - 1,
    )
    _global_channel = create_channel_with_id(GLOBAL_CHANNEL_ID, ChannelType.GLOBAL, None)

    import importlib

    from google.protobuf import symbol_database

    # Import data-type modules first (their generated protos must be in the
    # symbol database), register the operator's explicit DataMsgFullName
    # config next, and only then let module convention hooks fill the
    # remaining defaults — explicit config always wins.
    modules = []
    for mod_name in global_settings.import_modules:
        try:
            modules.append(importlib.import_module(mod_name))
        except ImportError:
            logger.error("failed to import data-type module %s", mod_name)

    for ch_type, st in global_settings.channel_settings.items():
        if not st.data_msg_full_name:
            continue
        try:
            cls = symbol_database.Default().GetSymbol(st.data_msg_full_name)
        except KeyError:
            logger.error(
                "failed to find message type %s for channel data", st.data_msg_full_name
            )
            continue
        register_channel_data_type(ch_type, cls())

    for mod in modules:
        hook = getattr(mod, "register_channel_data_types", None)
        if callable(hook):
            hook()


def get_channel(channel_id: int) -> Optional[Channel]:
    return _all_channels.get(channel_id)


def get_global_channel() -> Optional[Channel]:
    return _global_channel


def all_channels() -> dict[int, Channel]:
    return _all_channels


def create_channel_with_id(channel_id: int, channel_type: int, owner) -> Channel:
    ch = Channel(channel_id, channel_type, owner)
    if ch.channel_type == ChannelType.ENTITY:
        from ..spatial.controller import get_spatial_controller
        from ..spatial.entity import FlatEntityGroupController

        ch.spatial_notifier = get_spatial_controller()
        ch.entity_controller = FlatEntityGroupController()
        ch.entity_controller.initialize(ch)
    _all_channels[ch.id] = ch
    try:
        asyncio.get_running_loop()
        ch.start_ticking()
    except RuntimeError:
        pass  # no loop (tests drive tick_once by hand)
    metrics.channel_num.labels(channel_type=ch.channel_type.name).inc()
    events.channel_created.broadcast(ch)
    return ch


def create_channel(channel_type: int, owner) -> Channel:
    """(ref: channel.go:211-256). GLOBAL cannot be re-created; spatial ids
    come from their own space."""
    if channel_type == ChannelType.GLOBAL and _global_channel is not None:
        raise ValueError("GLOBAL channel already exists")
    if channel_type == ChannelType.SPATIAL:
        channel_id = _spatial_alloc.next_id(lambda i: i in _all_channels)
        if channel_id is None:
            raise ChannelFullError("spatial channels are full")
    else:
        channel_id = _non_spatial_alloc.next_id(lambda i: i in _all_channels)
        if channel_id is None:
            raise ChannelFullError("non-spatial channels are full")
    return create_channel_with_id(channel_id, channel_type, owner)


def create_entity_channel(entity_id: int, owner) -> Channel:
    """Entity channels use the fixed id == entityId, which must lie in the
    entity id space (ref: message_spatial.go:204-213, channel.go:229-241)."""
    if entity_id < global_settings.entity_channel_id_start:
        raise ValueError(f"entityId {entity_id} below the entity channel id space")
    if entity_id in _all_channels:
        raise ChannelFullError(f"entity channel {entity_id} already exists")
    return create_channel_with_id(entity_id, ChannelType.ENTITY, owner)


def remove_channel(ch: Channel) -> None:
    """(ref: channel.go:258-282)."""
    events.channel_removing.broadcast(ch)
    if ch.channel_type == ChannelType.ENTITY and ch.entity_controller is not None:
        ch.entity_controller.uninitialize(ch)
        events.auth_complete.unlisten_for(ch)
    ch.removing = True
    if ch._tick_task is not None:
        ch._tick_task.cancel()
        ch._tick_task = None
    # A removed channel can never drain: lift its backpressure now or the
    # reactors that fed it would wait forever.
    _congested_channels.discard(ch.id)
    _signal_drain()
    _all_channels.pop(ch.id, None)
    metrics.channel_num.labels(channel_type=ch.channel_type.name).dec()
    if _wal.enabled:
        _wal.log_channel_removed(ch.id)
    events.channel_removed.broadcast(ch.id)


def _remove_channel_after_owner_removed(ch: Channel) -> None:
    """(ref: channel.go:477-493)."""
    ch.removing = True
    if ch is not _global_channel and _global_channel is not None:
        from .message import MESSAGE_MAP
        from ..protocol import wire_pb2

        _global_channel.put_message(
            control_pb2.RemoveChannelMessage(channelId=ch.id),
            MESSAGE_MAP[MessageType.REMOVE_CHANNEL].handler,
            None,
            wire_pb2.MessagePack(channelId=GLOBAL_CHANNEL_ID, msgType=MessageType.REMOVE_CHANNEL),
        )
    ch.logger.info("removing channel after the owner is removed")


def reset_channels() -> None:
    """Test hook: drop every channel including GLOBAL."""
    global _global_channel
    for ch in list(_all_channels.values()):
        ch.removing = True
        if ch._tick_task is not None:
            ch._tick_task.cancel()
    _all_channels.clear()
    _global_channel = None
