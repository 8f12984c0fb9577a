"""ChannelData: state, update buffering, merge, and fan-out scheduling.

Capability parity with the reference data plane (ref: pkg/channeld/data.go):
the channel state message, a bounded ring of buffered updates, per-subscriber
fan-out on independent cadences with accumulation of the updates that arrived
in (lastFanOut, nextFanOut], first-fan-out-sends-full-state, field-mask
filtering, and reflection- or custom-merge with merge options.

The per-subscriber "is it due / what accumulates" decision here is the
host-semantics path; ops/fanout.py provides the batched device equivalent
used by the TPU decision plane.
"""

from __future__ import annotations

import time as _time
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional, Protocol, runtime_checkable

from google.protobuf.message import Message

from ..protocol import control_pb2
from ..utils.anyutil import pack_any, unpack_any
from ..utils.fieldmask import filter_fields
from ..utils.logger import get_logger
from .overload import governor as _governor
from .slo import slo as _slo
from .types import ChannelDataAccess, ChannelType, MessageType

if TYPE_CHECKING:
    from .channel import Channel

logger = get_logger("data")

MAX_UPDATE_MSG_BUFFER_SIZE = 512

# Balancer handle bound lazily (core must not import the spatial package
# at module load).
_balancer = None


def _note_spatial_fanout(channel, nbytes: int) -> None:
    """Feed the balancer's per-cell fan-out byte signal (SPATIAL
    channels only — entity/global fan-out is attributed via entity
    counts and server pressure instead)."""
    global _balancer
    if _balancer is None:
        from ..spatial.balancer import balancer as _balancer_mod

        _balancer = _balancer_mod
    _balancer.note_fanout_bytes(channel.id, nbytes)

# channel-type -> protobuf template for reflection-created channel data
# (ref: data.go:62 RegisterChannelDataType).
_channel_data_type_registry: dict[int, Message] = {}
# channel-type -> ChannelDataExtension factory (ref: data.go:390-416).
_channel_data_extension_registry: dict[int, Callable[[], "ChannelDataExtension"]] = {}


def register_channel_data_type(channel_type: int, template: Message) -> None:
    if channel_type in _channel_data_type_registry:
        logger.warning("channel data type already registered for %s", channel_type)
        return
    _channel_data_type_registry[channel_type] = template


def set_channel_data_extension(
    channel_type: int, factory: Callable[[], "ChannelDataExtension"]
) -> None:
    _channel_data_extension_registry[channel_type] = factory


def reflect_channel_data_message(channel_type: int) -> Optional[Message]:
    template = _channel_data_type_registry.get(channel_type)
    if template is None:
        return None
    return type(template)()


def reset_registries() -> None:
    """Test hook."""
    _channel_data_type_registry.clear()
    _channel_data_extension_registry.clear()


@runtime_checkable
class MergeableChannelData(Protocol):
    """Custom-merge hook (ref: data.go:321-324). Implemented by game data
    types that can fold an update in faster than reflection merge."""

    def merge(
        self,
        src: Message,
        options: Optional[control_pb2.ChannelDataMergeOptions],
        spatial_notifier,
    ) -> None: ...


@runtime_checkable
class ChannelDataInitializer(Protocol):
    """(ref: data.go:30-33)."""

    def init_data(self) -> None: ...


class ChannelDataExtension(Protocol):
    """Per-channel auxiliary state used for recovery payloads
    (ref: data.go:390-393)."""

    def init(self, channel: "Channel") -> None: ...
    def get_recovery_data_message(self) -> Optional[Message]: ...


# Channel time is integer nanoseconds since channel start (ref: ChannelTime
# is an int64 time.Duration) — integer math keeps window comparisons exact.
NS_PER_MS = 1_000_000


@dataclass
class UpdateBufferElement:
    update_msg: Message
    arrival_time: int  # ns, channel time
    sender_conn_id: int
    message_index: int
    # Host-monotonic connection-read stamp (0 = internal update): the
    # delivery-SLO plane measures ingest->fan-out against this
    # (core/slo.py record_delivery).
    ingest_ns: int = 0


@dataclass
class FanOutConnection:
    """(ref: data.go:39-44)."""

    conn: object  # ConnectionInChannel
    had_first_fanout: bool = False
    last_fanout_time: int = 0  # ns, channel time
    last_message_index: int = 0
    # Device fan-out plane (spatial channels with a TPU controller): the
    # engine sub-table slot whose batched due bit replaces the per-sub
    # host time check (consumed via the controller's pending due queue).
    device_sub_slot: Optional[int] = None


class IncompatibleUpdateError(TypeError):
    """An update's message type doesn't match the channel's data type.
    Family merges raise this (not bare TypeError) so the drop guard can't
    swallow genuine programming TypeErrors from inside merge logic."""


class ChannelData:
    def __init__(
        self,
        msg: Optional[Message],
        merge_options: Optional[control_pb2.ChannelDataMergeOptions] = None,
        channel_type: Optional[int] = None,
    ):
        self.msg = msg
        self.merge_options = merge_options
        # For late-binding adoption checks (first update sets the data):
        # if a data type gets registered for this channel type, an
        # adopting update must match it.
        self.channel_type = channel_type
        self.update_msg_buffer: list[UpdateBufferElement] = []
        self.accumulated_update_msg: Optional[Message] = (
            type(msg)() if msg is not None else None
        )
        self.msg_index = 0
        self.max_fanout_interval_ms = 0
        # Arrival time (channel ns) of the newest update EVICTED from the
        # ring: a subscriber whose catch-up window starts at or before
        # this mark has a delta gap and must take a full-state resync.
        self.evicted_through = 0
        self.extension: Optional[ChannelDataExtension] = None

    def on_update(
        self,
        update_msg: Message,
        arrival_time: int,
        sender_conn_id: int,
        spatial_notifier=None,
        now_ns: Optional[int] = None,
        ingest_ns: int = 0,
    ) -> None:
        """(ref: data.go:149-173). ``now_ns`` optionally bounds stray
        arrival stamps to the channel's own clock; ``ingest_ns`` is the
        connection-read host stamp the delivery-SLO plane threads to
        the fan-out (0 = internal)."""
        if self.msg is None:
            # Adoption (channeld-tpu extension; the reference drops updates
            # until data is initialized): only write-access subscribers
            # reach here, and if a data type IS registered for this
            # channel type by now, the adopting update must match it — a
            # single mistyped update must not wedge the channel forever.
            if self.channel_type is not None:
                expected = reflect_channel_data_message(self.channel_type)
                if expected is not None and type(expected) is not type(update_msg):
                    logger.warning(
                        "refusing to initialize channel data with %s "
                        "(registered type is %s)",
                        type(update_msg).DESCRIPTOR.full_name,
                        type(expected).DESCRIPTOR.full_name,
                    )
                    return
            self.msg = update_msg
            logger.info(
                "initialized channel data with update message from conn %d",
                sender_conn_id,
            )
        else:
            merged = merge_with_options(
                self.msg, update_msg, self.merge_options, spatial_notifier
            )
            if not merged:
                # Dropped (incompatible type): it must not enter the
                # update ring either — a buffered wrong-type message would
                # fan out verbatim or crash window accumulation later.
                return
            if type(update_msg) is not type(self.msg):
                # A custom merge took an update of another message family
                # with the same fields (models/chat.py): the ring holds the
                # channel's own type, or window accumulation's MergeFrom
                # raises and the channel's tick task dies (ROADMAP F20).
                own = type(self.msg)()
                own.ParseFromString(update_msg.SerializeToString())
                update_msg = own
        self.msg_index += 1
        # The fan-out windowing bisects this buffer, which requires arrival
        # times to be monotonic in this channel's clock. Clamp stray stamps
        # in both directions (e.g. a context forwarded from another channel
        # carries that channel's time base): never before the tail, never
        # ahead of this channel's own now.
        tail = self.update_msg_buffer[-1].arrival_time if self.update_msg_buffer else 0
        if now_ns is not None:
            arrival_time = min(arrival_time, now_ns)
        arrival_time = max(arrival_time, tail)
        self.update_msg_buffer.append(
            UpdateBufferElement(update_msg, arrival_time, sender_conn_id,
                                self.msg_index, ingest_ns)
        )
        if len(self.update_msg_buffer) > MAX_UPDATE_MSG_BUFFER_SIZE:
            oldest = self.update_msg_buffer[0]
            # Only drop it once every subscriber must have seen it. Under
            # a brownout stretch the subscribers legitimately run slower,
            # so the retention horizon stretches with them; subscribers
            # held even longer (the L2+ priority shed) are caught by the
            # evicted_through mark and resynced with full state.
            retention_ns = self.max_fanout_interval_ms * NS_PER_MS
            if _governor.level:
                retention_ns = int(retention_ns * _governor.fanout_stretch())
            if oldest.arrival_time + retention_ns < arrival_time:
                self.update_msg_buffer.pop(0)
                if oldest.arrival_time > self.evicted_through:
                    self.evicted_through = oldest.arrival_time


def _accumulate_window(data: "ChannelData", window: list, fresh: bool = False):
    """Merge a window of buffered updates: first entry is a plain copy,
    the rest merge with options (ref: data.go hasEverMerged). ``fresh``
    returns a new message (safe to cache); otherwise the channel's
    scratch accumulator is reused (consume before the next call)."""
    if fresh:
        acc = type(data.msg)()
    else:
        if data.accumulated_update_msg is None:
            data.accumulated_update_msg = type(data.msg)()
        else:
            data.accumulated_update_msg.Clear()
        acc = data.accumulated_update_msg
    acc.MergeFrom(window[0].update_msg)
    for be in window[1:]:
        merge_with_options(acc, be.update_msg, data.merge_options, None)
    return acc


def _newest_ingest_ns(window: list) -> int:
    """The newest non-zero connection-read stamp in a delivered window
    (0 when every update was internal). Windows are small (bounded by
    the update ring); the scan usually exits on the last element."""
    for be in reversed(window):
        if be.ingest_ns:
            return be.ingest_ns
    return 0


def _record_window_delivery(channel: "Channel", window: list,
                            path: str) -> None:
    """One delivery-latency sample for a just-sent fan-out window,
    stamped with the NEWEST externally-ingested update it carries
    (core/slo.py; the pipeline-transit reading of delivery latency)."""
    ingest_ns = _newest_ingest_ns(window)
    if ingest_ns:
        _slo.record_delivery(channel.channel_type.name, path, ingest_ns)


def _device_due_view(channel: "Channel"):
    """(ctl, engine_seq, pending {slot: seq}) from the TPU controller's
    batched ticks, for spatial channels with device-registered subs;
    None -> host path (ref: the host scan this replaces is
    data.go:175-291). Pending entries survive engine ticks until this
    channel consumes them."""
    if not channel.device_sub_slots:
        return None
    from ..spatial.controller import get_spatial_controller

    ctl = get_spatial_controller()
    view = getattr(ctl, "device_due", None)
    if view is None:
        return None
    due = view(channel.id)
    if due is None:
        return None
    return (ctl,) + due


def tick_data(channel: "Channel", now: int) -> None:
    """The per-tick fan-out decision + send loop (ref: data.go:175-291).

    ``now`` is channel time (integer ns since channel start) so tests can
    drive it with a synthetic clock.

    Spatial channels under a TPU controller consume the batched device due
    mask: only subscribers the engine marked due are visited (flat host
    cost in subscriber count); subscriptions without a device slot — table
    full or pre-engine — keep the host time check.
    """
    data = channel.data
    if data is None or data.msg is None:
        return

    # Buffered updates arrive in channel-time order, so each subscriber's
    # inclusive [last, last+interval] window (the reference's bounds,
    # boundary elements delivered twice like data.go:230-258) is a
    # contiguous slice — O(log B) to locate instead of scanning the whole
    # ring per subscriber. Built lazily: ticks with no due subscriber pay
    # nothing.
    arrivals = None
    # Subscribers sharing the same window slice get the same accumulated
    # message unless skip-self excludes one of their own updates from it:
    # (lo, hi) -> [sender_id_set, merged_msg_or_None]. Scoped to this
    # tick; fan_out_data_update never mutates what it sends.
    shared_windows: dict = {}
    body_cache: dict = {}  # id(update_msg) -> (msg ref, shared MessageContext)

    # Overload brownout (doc/overload.md), resolved once per tick:
    # L1+ stretches every subscriber's effective fan-out interval (the
    # update ring keeps accumulating, so delivery coalesces — nothing is
    # lost); L2+ withholds updates from the lowest-priority
    # subscriptions entirely, each withheld delivery counted.
    stretch = _governor.fanout_stretch() if _governor.level else 1.0
    shed_floor = _governor.shed_priority_floor() if _governor.level else None

    queue = channel.fan_out_queue
    device = _device_due_view(channel)
    if device is not None:
        ctl, seq, pending = device
        # Consume this channel's own pending due decisions — O(own due),
        # never an iteration of the slot table or the fan-out queue —
        # plus any host-fallback entries.
        iterate = []
        slots = channel.device_sub_slots
        for slot in list(pending):
            del pending[slot]
            foc = slots.get(slot)
            if foc is not None:
                iterate.append(foc)
        iterate.extend(channel.device_fallback_focs)
    else:
        iterate = list(queue)

    for foc in iterate:
        conn = foc.conn
        if conn is None or conn.is_closing():
            try:
                queue.remove(foc)
            except ValueError:
                pass
            from .subscription import release_device_fanout

            release_device_fanout(channel, foc)
            continue
        cs = channel.subscribed_connections.get(conn)
        if cs is None or cs.options.dataAccess == ChannelDataAccess.NO_ACCESS:
            continue

        #  |------FanOutDelay------|---FanOutInterval---|
        #  subTime                 firstFanOut          secondFanOut
        interval_ns = cs.options.fanOutIntervalMs * NS_PER_MS
        if stretch != 1.0:
            interval_ns = int(interval_ns * stretch)
        next_fanout_time = foc.last_fanout_time + interval_ns
        if device is None or foc.device_sub_slot is None:
            # Host time check (no engine, or no device slot for this sub).
            if now < next_fanout_time:
                continue
        else:
            # The device already decided this sub is due. Under a
            # brownout stretch the governor overrides the device's
            # cadence: hold the fan-out until the stretched interval
            # elapses (the engine re-marks the sub due next window, so
            # nothing is starved — just coalesced harder).
            if stretch != 1.0 and now < next_fanout_time:
                continue
            # The engine clock can run marginally ahead of this
            # channel's; clamp the window end so the bisect below never
            # claims unseen future arrivals.
            next_fanout_time = min(next_fanout_time, now)

        if (
            shed_floor is not None
            and cs.priority >= shed_floor
            and foc.had_first_fanout
        ):
            # Shed: a DUE delivery is withheld while the ladder holds
            # (first fan-out still goes out so fresh subs handshake) —
            # one count per withheld delivery. The window keeps
            # accumulating from last_fanout_time; delivery resumes,
            # coalesced, once the ladder releases.
            _governor.count_shed("update_priority")
            continue

        latest_fanout_time = next_fanout_time

        if not foc.had_first_fanout:
            # First fan-out carries the full channel state.
            fan_out_data_update(channel, conn, cs, data.msg, body_cache)
            foc.had_first_fanout = True
            foc.last_message_index = data.msg_index
            latest_fanout_time = now
            if device is not None and foc.device_sub_slot is not None:
                # Mirror the window snap on the device sub clock.
                ctl.device_sub_first_fanout(foc.device_sub_slot)
        elif (
            data.evicted_through > 0
            and foc.last_fanout_time <= data.evicted_through
        ):
            # Ring gap: updates this subscriber never saw were evicted
            # (it was held past the retention horizon — e.g. the L2+
            # priority shed). Deltas can't reconstruct its view, so
            # resync with full state — this is what keeps the brownout
            # lossless at the STATE level no matter how long the hold.
            fan_out_data_update(channel, conn, cs, data.msg, body_cache)
            foc.last_message_index = data.msg_index
            latest_fanout_time = now
        elif data.update_msg_buffer:
            if arrivals is None:
                arrivals = [be.arrival_time for be in data.update_msg_buffer]
            last_update_time = max(foc.last_fanout_time, 0)
            lo = bisect_left(arrivals, last_update_time)
            hi = bisect_right(arrivals, next_fanout_time)
            entry = shared_windows.get((lo, hi))
            if entry is None:
                entry = shared_windows[(lo, hi)] = [
                    {be.sender_conn_id for be in data.update_msg_buffer[lo:hi]},
                    None,
                    False,  # delivery-SLO sample taken for this window
                ]
            if cs.options.skipSelfUpdateFanOut and conn.id in entry[0]:
                # This subscriber's own update is in the slice: accumulate
                # its personal window with the self-updates excluded.
                window = [
                    be for be in data.update_msg_buffer[lo:hi]
                    if be.sender_conn_id != conn.id
                ]
                if window:
                    foc.last_message_index = window[-1].message_index
                    if len(window) == 1:
                        # A single foreign update is a stable buffered
                        # message — cache-safe like the shared path.
                        fan_out_data_update(
                            channel, conn, cs, window[0].update_msg, body_cache
                        )
                    else:
                        # The scratch accumulator is reused next call; its
                        # bytes must not enter the shared cache.
                        fan_out_data_update(
                            channel, conn, cs, _accumulate_window(data, window)
                        )
                    if _slo.enabled:
                        _record_window_delivery(
                            channel, window,
                            "device" if device is not None
                            and foc.device_sub_slot is not None
                            else "host",
                        )
            elif hi > lo:
                # Shared path: merge the slice once, reuse for every
                # subscriber with this exact window. The cached message
                # outlives this iteration, so it gets its own object
                # rather than the per-sub scratch accumulator.
                if entry[1] is None:
                    window = data.update_msg_buffer[lo:hi]
                    entry[1] = (
                        window[0].update_msg
                        if len(window) == 1
                        else _accumulate_window(data, window, fresh=True)
                    )
                foc.last_message_index = data.update_msg_buffer[hi - 1].message_index
                fan_out_data_update(channel, conn, cs, entry[1], body_cache)
                if _slo.enabled and not entry[2]:
                    # ONE sample per distinct window per tick, however
                    # many subscribers share it (bounded cost; the
                    # first deliverer's path labels it).
                    entry[2] = True
                    _record_window_delivery(
                        channel, data.update_msg_buffer[lo:hi],
                        "device" if device is not None
                        and foc.device_sub_slot is not None
                        else "host",
                    )

        foc.last_fanout_time = latest_fanout_time

    # Keep the queue ordered by last_fanout_time (the reference maintains
    # this invariant with in-place move-to-back; a stable sort is the same
    # end state). Device mode doesn't iterate the queue, so its order is
    # re-established lazily if the engine ever goes away.
    if device is None:
        queue.sort(key=lambda f: f.last_fanout_time)


def fan_out_data_update(
    channel: "Channel", conn, cs, update_msg: Message,
    body_cache: Optional[dict] = None,
) -> None:
    """(ref: data.go:293-318).

    ``body_cache`` (tick-scoped) shares the serialized update across
    subscribers receiving the identical message: a broadcast channel
    encodes each window once, not once per recipient. Values hold the
    source message alongside the bytes so an ``id()`` key can't be
    recycled mid-tick.
    """
    if cs.options.dataFieldMasks:
        update_msg = _filtered_copy(update_msg, list(cs.options.dataFieldMasks))
        body_cache = None  # per-subscriber content
    from .message import MessageContext  # local: message imports data

    spatial = channel.channel_type == ChannelType.SPATIAL
    hit = body_cache.get(id(update_msg)) if body_cache is not None else None
    if hit is not None:
        if spatial and hit[1].raw_body is not None:
            _note_spatial_fanout(channel, len(hit[1].raw_body))
        conn.send(hit[1])
        return
    ctx = MessageContext(
        msg_type=MessageType.CHANNEL_DATA_UPDATE,
        msg=control_pb2.ChannelDataUpdateMessage(data=pack_any(update_msg)),
        channel=channel,
        channel_id=channel.id,
    )
    ctx.ensure_raw_body()
    if spatial and ctx.raw_body is not None:
        _note_spatial_fanout(channel, len(ctx.raw_body))
    if body_cache is not None:
        # The queued sender consumes the context immediately (tuple into
        # the send queue), so one context object serves every recipient.
        body_cache[id(update_msg)] = (update_msg, ctx)
    conn.send(ctx)


def _filtered_copy(msg: Message, masks: list[str]) -> Message:
    # The same accumulated message fans out to many subscribers with
    # different masks — never mutate the shared instance.
    out = type(msg)()
    out.CopyFrom(msg)
    filter_fields(out, masks)
    return out


def merge_with_options(
    dst: Message,
    src: Message,
    options: Optional[control_pb2.ChannelDataMergeOptions],
    spatial_notifier=None,
) -> bool:
    """(ref: data.go:326-347). Returns False when the update was DROPPED
    as type-incompatible (the caller must then keep it out of the update
    ring); True otherwise. The reference's reflection merge would panic
    the channel goroutine on mismatched descriptors; here it is a clean
    warning drop — one line, not a stack trace, or a hostile client
    could flood the log."""
    merge = getattr(dst, "merge", None)
    if callable(merge):
        if options is None:
            options = control_pb2.ChannelDataMergeOptions(
                shouldCheckRemovableMapField=True
            )
        try:
            merge(src, options, spatial_notifier)
        except IncompatibleUpdateError as e:
            logger.warning("dropping incompatible update: %s", e)
            return False
        except Exception:
            # Genuine merge bugs keep their stack traces.
            logger.exception("custom merge error")
    else:
        if type(dst) is not type(src):
            logger.warning(
                "dropping update of type %s: channel data is %s",
                type(src).DESCRIPTOR.full_name, type(dst).DESCRIPTOR.full_name,
            )
            return False
        reflect_merge(dst, src, options)
    return True


def reflect_merge(
    dst: Message,
    src: Message,
    options: Optional[control_pb2.ChannelDataMergeOptions],
) -> None:
    """Reflection-based merge honoring merge options (ref: data.go:349-388)."""
    dst.MergeFrom(src)
    if options is None:
        return
    for fd, value in dst.ListFields():
        is_map = (
            fd.type == fd.TYPE_MESSAGE and fd.message_type.GetOptions().map_entry
        )
        if is_map:
            if options.shouldCheckRemovableMapField:
                field_map = getattr(dst, fd.name)
                value_desc = fd.message_type.fields_by_name["value"]
                if value_desc.type == value_desc.TYPE_MESSAGE and (
                    "removed" in value_desc.message_type.fields_by_name
                ):
                    for key in [
                        k for k, v in field_map.items() if getattr(v, "removed", False)
                    ]:
                        del field_map[key]
        elif fd.is_repeated:
            lst = getattr(dst, fd.name)
            if options.shouldReplaceList:
                src_list = getattr(src, fd.name)
                del lst[:]
                lst.extend(src_list)
            if options.listSizeLimit > 0:
                offset = len(lst) - options.listSizeLimit
                if offset > 0:
                    if options.truncateTop:
                        keep = list(lst[offset:])
                    else:
                        keep = list(lst[: options.listSizeLimit])
                    del lst[:]
                    lst.extend(keep)


def unwrap_update_any(any_msg) -> Message:
    return unpack_any(any_msg)


def channel_now() -> float:
    return _time.monotonic()
