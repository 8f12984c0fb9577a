"""Deterministic, seeded wire-protocol fuzzer (doc/edge_hardening.md).

The adversarial complement to the scenario-driven chaos plane: instead of
replaying *plausible* faults (loss, reorder, partitions), this module throws
*implausible* bytes — truncated and oversized length prefixes, torn frames,
bit-flipped protobuf bodies, valid protos in the wrong FSM state, replayed
auth, mid-handshake closes — at a real in-process gateway and checks three
invariants after every input:

  1. **No uncaught exception reaches the event loop.** The TCP receive path
     (``_TcpServerProtocol.data_received`` -> ``Connection.on_bytes``) runs
     uncaught on the loop; anything a hostile peer can make escape there is
     gateway-fatal, not connection-fatal, and is exactly the defect class
     the edge plane exists to make impossible.
  2. **No per-connection resource leaves its envelope.** Every connection's
     send queue stays within ``-edge-queue-msgs`` / ``-edge-queue-bytes``
     (core/edge.py) no matter what the peer did.
  3. **The honest census stays exact.** A well-behaved authenticated client
     and the GLOBAL owner survive every hostile input — open, authenticated,
     owner intact — and a periodic user-space round-trip still delivers.

Determinism: every case derives from ``master_seed ^ iteration`` through
``random.Random`` only; no wall-clock feeds case generation, and channel
time is advanced synthetically by the pump. Replaying a saved case byte
stream is therefore exact at the decode/dispatch layer (ladder *timing* —
quarantine grace windows — still reads the monotonic clock, which is fine:
the oracle checks bounds, not schedules).

Corpus discipline: a violating input is shrunk by a bounded ddmin-lite pass
(drop ops, then halve byte ranges) and written as JSON to the regression
corpus (tests/corpus/wire/). tests/test_edge.py replays every corpus file
in tier-1, so a fixed defect stays fixed.

Thread model: everything here runs on the event-loop thread of the harness'
``asyncio.run``; the harness owns every registry it touches (it boots a
private gateway per run).
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import traceback
from dataclasses import dataclass, field
from random import Random
from typing import Callable, Optional

from ..utils.logger import get_logger

logger = get_logger("fuzz")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
CORPUS_DIR = os.path.join(REPO, "tests", "corpus", "wire")

# An op is one step of a hostile session:
#   ("data", <bytes>)  -> one data_received() call
#   ("pump",)          -> one gateway pump (tick + flush + edge tick)
#   ("close",)         -> connection_lost() (peer vanished mid-anything)
Op = tuple


@dataclass
class FuzzCase:
    """One hostile session: an op list against a fresh peer socket."""

    kind: str
    seed: int
    ops: list
    auth_first: bool = False  # complete a real handshake before the ops

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "seed": self.seed,
            "auth_first": self.auth_first,
            "ops": [
                ["data", op[1].hex()] if op[0] == "data" else [op[0]]
                for op in self.ops
            ],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "FuzzCase":
        ops = []
        for op in obj["ops"]:
            if op[0] == "data":
                ops.append(("data", bytes.fromhex(op[1])))
            else:
                ops.append((op[0],))
        return cls(
            kind=obj["kind"],
            seed=int(obj.get("seed", 0)),
            ops=ops,
            auth_first=bool(obj.get("auth_first", False)),
        )


@dataclass
class Violation:
    """One oracle breach, with enough context to reproduce it."""

    oracle: str  # event_loop_exception | envelope | census | roundtrip
    detail: str
    case: Optional[FuzzCase] = None


# ---------------------------------------------------------------------------
# frame builders
# ---------------------------------------------------------------------------


def _frame(msg_type: int, body: bytes, channel_id: int = 0) -> bytes:
    from ..protocol import encode_packet, wire_pb2

    return encode_packet(
        wire_pb2.Packet(
            messages=[
                wire_pb2.MessagePack(
                    channelId=channel_id, msgType=msg_type, msgBody=body
                )
            ]
        )
    )


def _auth_frame(pit: str) -> bytes:
    from ..core.types import MessageType
    from ..protocol import control_pb2

    return _frame(
        MessageType.AUTH,
        control_pb2.AuthMessage(
            playerIdentifierToken=pit, loginToken="fuzz"
        ).SerializeToString(),
    )


def _valid_frames(rng: Random) -> list:
    """A pool of well-formed frames to mutate — every system body the
    client FSM can reach, plus user-space forwards."""
    from ..core.types import MessageType
    from ..protocol import control_pb2

    return [
        _auth_frame("fuzz-pit-%d" % rng.randrange(1 << 16)),
        _frame(
            MessageType.SUB_TO_CHANNEL,
            control_pb2.SubscribedToChannelMessage(
                connId=rng.randrange(1 << 10)
            ).SerializeToString(),
        ),
        _frame(
            MessageType.CREATE_CHANNEL,
            control_pb2.CreateChannelMessage(
                channelType=rng.choice([0, 1, 2, 3, 7]),
                metadata="fuzz",
            ).SerializeToString(),
        ),
        _frame(
            MessageType.REMOVE_CHANNEL,
            control_pb2.RemoveChannelMessage(
                channelId=rng.randrange(1 << 8)
            ).SerializeToString(),
        ),
        _frame(
            MessageType.DISCONNECT,
            control_pb2.DisconnectMessage(
                connId=rng.randrange(1 << 10)
            ).SerializeToString(),
        ),
        _frame(100 + rng.randrange(8), rng.randbytes(rng.randrange(1, 64))),
    ]


def _bitflip(data: bytes, rng: Random, flips: int) -> bytes:
    buf = bytearray(data)
    for _ in range(flips):
        i = rng.randrange(len(buf))
        buf[i] ^= 1 << rng.randrange(8)
    return bytes(buf)


def _tear(data: bytes, rng: Random) -> list:
    """Split one byte stream into 2..5 data ops with pumps between —
    the decoder must reassemble across reads."""
    cuts = sorted(rng.sample(range(1, len(data)), min(len(data) - 1, rng.randrange(1, 5))))
    ops = []
    prev = 0
    for cut in cuts + [len(data)]:
        ops.append(("data", data[prev:cut]))
        if rng.random() < 0.5:
            ops.append(("pump",))
        prev = cut
    return ops


# ---------------------------------------------------------------------------
# case generators — one per hostile input family
# ---------------------------------------------------------------------------


def _gen_garbage(rng: Random) -> list:
    return [
        ("data", rng.randbytes(rng.randrange(1, 512)))
        for _ in range(rng.randrange(1, 4))
    ]


def _gen_bitflip_valid(rng: Random) -> list:
    frame = rng.choice(_valid_frames(rng))
    return [("data", _bitflip(frame, rng, rng.randrange(1, 9)))]


def _gen_truncate(rng: Random) -> list:
    frame = rng.choice(_valid_frames(rng))
    cut = rng.randrange(1, len(frame))
    ops = [("data", frame[:cut]), ("pump",)]
    if rng.random() < 0.5:
        ops.append(("data", rng.randbytes(rng.randrange(1, 64))))
    else:
        ops.append(("close",))
    return ops


def _gen_torn(rng: Random) -> list:
    frame = rng.choice(_valid_frames(rng))
    return _tear(frame, rng)


def _gen_oversize_prefix(rng: Random) -> list:
    # Header claims up to MAX_PACKET_SIZE; the body never (or partially)
    # arrives. The decoder must hold bounded state and teardown cleanly.
    size = rng.choice([0xFFFF, 0xFFFE, 0x8000, rng.randrange(1024, 0xFFFF)])
    header = b"CH" + struct.pack(">H", size) + bytes([rng.randrange(2)])
    ops = [("data", header), ("pump",)]
    if rng.random() < 0.5:
        ops.append(("data", rng.randbytes(rng.randrange(1, size))))
    ops.append(("close",) if rng.random() < 0.5 else ("pump",))
    return ops


def _gen_bad_header(rng: Random) -> list:
    choice = rng.randrange(3)
    if choice == 0:  # zero-size frame
        data = b"CH\x00\x00\x00"
    elif choice == 1:  # bad magic
        data = rng.randbytes(2) + struct.pack(">H", rng.randrange(64)) + b"\x00"
    else:  # snappy tag over garbage
        body = rng.randbytes(rng.randrange(1, 128))
        data = b"CH" + struct.pack(">H", len(body)) + b"\x01" + body
    return [("data", data)]


def _gen_wrong_state(rng: Random) -> list:
    # Valid protos the FSM must refuse in the current state (INIT unless
    # auth_first): subs, updates, forwards before auth; double auth after.
    frames = _valid_frames(rng)
    picks = rng.sample(frames, rng.randrange(1, min(4, len(frames))))
    ops = []
    for f in picks:
        ops.append(("data", f))
        ops.append(("pump",))
    return ops


def _gen_replay_auth(rng: Random) -> list:
    frame = _auth_frame("replay-%d" % rng.randrange(1 << 12))
    return [("data", frame), ("pump",), ("data", frame), ("pump",)]


def _gen_mid_handshake_close(rng: Random) -> list:
    frame = _auth_frame("gone-%d" % rng.randrange(1 << 12))
    cut = rng.randrange(1, len(frame))
    return [("data", frame[:cut]), ("close",)]


def _gen_hostile_fields(rng: Random) -> list:
    # Structurally valid wire packet, adversarial field values: system
    # msgTypes the client should never speak, huge channel ids, junk
    # bodies under a real type tag.
    from ..protocol import encode_packet, wire_pb2

    packs = []
    for _ in range(rng.randrange(1, 6)):
        packs.append(
            wire_pb2.MessagePack(
                channelId=rng.choice([0, 1, 0xFFFF, (1 << 31) - 1]),
                msgType=rng.choice(
                    [0, 2, 9, 13, 19, 22, 24, 27, 30, 38, 50, 99, 100, 65535]
                ),
                msgBody=rng.randbytes(rng.randrange(64)),
                stubId=rng.choice([0, 1, 0xFFFFFFFF]),
                broadcast=rng.choice([0, 1, 3, 0xFF]),
            )
        )
    data = encode_packet(wire_pb2.Packet(messages=packs))
    return [("data", data), ("pump",)]


def _gen_splice(rng: Random) -> list:
    frames = _valid_frames(rng)
    a, b = rng.choice(frames), rng.choice(frames)
    glue = rng.randbytes(rng.randrange(0, 16))
    return _tear(a + glue + b, rng)


def _gen_spatial_probe(rng: Random) -> list:
    # The client FSM whitelists 15-65535, which includes the whole
    # spatial/entity plane — probe those handlers with valid-ish and
    # garbage bodies against a gateway with NO spatial controller.
    from ..core.types import MessageType
    from ..protocol import spatial_pb2

    builders = [
        lambda: (
            MessageType.QUERY_SPATIAL_CHANNEL,
            spatial_pb2.QuerySpatialChannelMessage().SerializeToString(),
        ),
        lambda: (
            MessageType.UPDATE_SPATIAL_INTEREST,
            spatial_pb2.UpdateSpatialInterestMessage(
                connId=rng.randrange(1 << 10)
            ).SerializeToString(),
        ),
        lambda: (
            MessageType.CREATE_ENTITY_CHANNEL,
            spatial_pb2.CreateEntityChannelMessage(
                entityId=rng.randrange(1 << 31)
            ).SerializeToString(),
        ),
        lambda: (
            MessageType.ENTITY_GROUP_ADD,
            rng.randbytes(rng.randrange(32)),
        ),
        lambda: (
            MessageType.ENTITY_GROUP_REMOVE,
            rng.randbytes(rng.randrange(32)),
        ),
        lambda: (
            MessageType.CHANNEL_DATA_HANDOVER,
            rng.randbytes(rng.randrange(64)),
        ),
        lambda: (MessageType.SPATIAL_CHANNELS_READY, b""),
    ]
    ops = []
    for _ in range(rng.randrange(1, 4)):
        mt, body = rng.choice(builders)()
        ops.append(("data", _frame(mt, body, rng.choice([0, 1, 0xFFFF]))))
        ops.append(("pump",))
    return ops


def _gen_query_probe(rng: Random) -> list:
    # Hostile standing-query registrations (spatial/messages.py
    # _validate_interest_query): NaN/inf centers, negative radii/angles,
    # spot lists past the queryplane_max_spots cap. The handler must
    # reject-and-count every one (query_malformed_total) without letting
    # a non-finite float near the device query table.
    from ..core.types import MessageType
    from ..protocol import spatial_pb2

    nan, inf = float("nan"), float("inf")

    def _msg():
        return spatial_pb2.UpdateSpatialInterestMessage(
            connId=rng.randrange(1 << 10)
        )

    def _bad_sphere():
        m = _msg()
        m.query.sphereAOI.center.x = rng.choice([nan, inf, -inf, 0.0])
        m.query.sphereAOI.center.z = rng.choice([nan, 1e308, 0.0])
        m.query.sphereAOI.radius = rng.choice([nan, inf, -1.0, -1e30, 50.0])
        return m

    def _bad_box():
        m = _msg()
        m.query.boxAOI.center.x = rng.choice([nan, inf, 0.0])
        m.query.boxAOI.extent.x = rng.choice([nan, -inf, -4.0, 100.0])
        m.query.boxAOI.extent.z = rng.choice([inf, -1.0, 100.0])
        return m

    def _bad_cone():
        m = _msg()
        m.query.coneAOI.center.z = rng.choice([nan, -inf, 0.0])
        m.query.coneAOI.direction.x = rng.choice([nan, inf, 1.0])
        m.query.coneAOI.angle = rng.choice([nan, -0.5, inf, 0.7])
        m.query.coneAOI.radius = rng.choice([-inf, nan, -2.0, 80.0])
        return m

    def _oversize_spots():
        m = _msg()
        for i in range(rng.randrange(257, 400)):
            s = m.query.spotsAOI.spots.add()
            s.x, s.z = float(i), float(i)
        return m

    def _nan_spots():
        m = _msg()
        for _ in range(rng.randrange(1, 8)):
            s = m.query.spotsAOI.spots.add()
            s.x = rng.choice([nan, inf, -inf, 1.0])
            s.z = rng.choice([nan, 3.0])
        return m

    builders = [_bad_sphere, _bad_box, _bad_cone, _oversize_spots,
                _nan_spots]
    ops = []
    for _ in range(rng.randrange(1, 4)):
        body = rng.choice(builders)().SerializeToString()
        ops.append(("data", _frame(MessageType.UPDATE_SPATIAL_INTEREST,
                                   body, rng.choice([0, 1, 0xFFFF]))))
        ops.append(("pump",))
    return ops


def _gen_acl_spoof(rng: Random) -> list:
    # Sub/unsub with ANOTHER conn's id (1 = GLOBAL owner, 2 = the honest
    # client in this harness): the ACL must refuse the cross-conn op and
    # the census oracle must see the honest world untouched.
    from ..core.types import MessageType
    from ..protocol import control_pb2

    target = rng.choice([1, 2])
    ops = []
    for _ in range(rng.randrange(1, 3)):
        if rng.random() < 0.5:
            body = control_pb2.UnsubscribedFromChannelMessage(
                connId=target
            ).SerializeToString()
            ops.append(("data", _frame(MessageType.UNSUB_FROM_CHANNEL, body)))
        else:
            body = control_pb2.SubscribedToChannelMessage(
                connId=target
            ).SerializeToString()
            ops.append(("data", _frame(MessageType.SUB_TO_CHANNEL, body)))
        ops.append(("pump",))
    return ops


def _gen_recovery_probe(rng: Random) -> list:
    # Gateway->peer recovery/failover control types, reflected back by a
    # hostile client (20-27 sit inside the client whitelist).
    from ..core.types import MessageType

    types = [
        MessageType.RECOVERY_CHANNEL_DATA,
        MessageType.RECOVERY_END,
        MessageType.CHANNEL_OWNER_LOST,
        MessageType.CHANNEL_OWNER_RECOVERED,
        MessageType.CELL_REHOSTED,
        MessageType.CELL_MIGRATED,
        MessageType.CLIENT_REDIRECT,
    ]
    ops = []
    for _ in range(rng.randrange(1, 4)):
        ops.append(
            ("data", _frame(rng.choice(types), rng.randbytes(rng.randrange(48))))
        )
        ops.append(("pump",))
    return ops


def _gen_data_update(rng: Random) -> list:
    # CHANNEL_DATA_UPDATE with a hostile Any: garbage type_url, wrong
    # payload under a real url, or random bytes where the Any should be.
    from ..core.types import MessageType
    from ..protocol import control_pb2

    choice = rng.randrange(3)
    if choice == 0:
        msg = control_pb2.ChannelDataUpdateMessage()
        msg.data.type_url = "type.googleapis.com/" + "".join(
            chr(rng.randrange(33, 127)) for _ in range(rng.randrange(1, 40))
        )
        msg.data.value = rng.randbytes(rng.randrange(128))
        body = msg.SerializeToString()
    elif choice == 1:
        msg = control_pb2.ChannelDataUpdateMessage()
        msg.data.type_url = "type.googleapis.com/channeld.SpatialChannelDataMessage"
        msg.data.value = rng.randbytes(rng.randrange(128))
        body = msg.SerializeToString()
    else:
        body = rng.randbytes(rng.randrange(1, 96))
    return [("data", _frame(MessageType.CHANNEL_DATA_UPDATE, body)), ("pump",)]


def _gen_oversize_forward(rng: Random) -> list:
    # A user-space forward near the 64KB frame cap: the egress wrap adds
    # bytes, so re-encode must split or drop WITHOUT killing the pump.
    from ..protocol.framing import FramingError

    mt = 100 + rng.randrange(4)
    overhead = len(_frame(mt, b"")) - 5 + 8  # proto wrap + grown varints
    size = 0xFFFF - overhead - rng.randrange(4)
    body = rng.randbytes(size)
    while True:  # creep up against the exact cap
        try:
            frame = _frame(mt, body)
        except FramingError:
            body = body[:-4]
            continue
        break
    return [("data", frame), ("pump",), ("pump",)]


def _gen_frame_flood(rng: Random) -> list:
    # Hundreds of valid frames in single reads: drives the ingress
    # token bucket into strikes -> quarantine -> structured disconnect,
    # all under the envelope/census oracle.
    frame = _frame(100 + rng.randrange(4), rng.randbytes(rng.randrange(4, 32)))
    ops = []
    for _ in range(rng.randrange(2, 5)):
        ops.append(("data", frame * rng.randrange(50, 300)))
        if rng.random() < 0.5:
            ops.append(("pump",))
    ops.append(("pump",))
    return ops


GENERATORS: dict[str, Callable[[Random], list]] = {
    "garbage": _gen_garbage,
    "bitflip_valid": _gen_bitflip_valid,
    "truncate": _gen_truncate,
    "torn": _gen_torn,
    "oversize_prefix": _gen_oversize_prefix,
    "bad_header": _gen_bad_header,
    "wrong_state": _gen_wrong_state,
    "replay_auth": _gen_replay_auth,
    "mid_handshake_close": _gen_mid_handshake_close,
    "hostile_fields": _gen_hostile_fields,
    "splice": _gen_splice,
    "spatial_probe": _gen_spatial_probe,
    "query_probe": _gen_query_probe,
    "acl_spoof": _gen_acl_spoof,
    "recovery_probe": _gen_recovery_probe,
    "data_update": _gen_data_update,
    "oversize_forward": _gen_oversize_forward,
    "frame_flood": _gen_frame_flood,
}

# Families that exercise the authenticated FSM state get a handshake first
# half the time (always, where unauthenticated sends would just be FSM
# noise); pure framing attacks don't need one.
_AUTH_ELIGIBLE = {
    "bitflip_valid",
    "wrong_state",
    "hostile_fields",
    "splice",
    "garbage",
}
_AUTH_ALWAYS = {
    "spatial_probe",
    "query_probe",
    "acl_spoof",
    "recovery_probe",
    "data_update",
    "oversize_forward",
    "frame_flood",
}


def make_case(master_seed: int, iteration: int) -> FuzzCase:
    seed = (master_seed ^ (iteration * 0x9E3779B1)) & 0xFFFFFFFF
    rng = Random(seed)
    kind = rng.choice(sorted(GENERATORS))
    auth_first = kind in _AUTH_ALWAYS or (
        kind in _AUTH_ELIGIBLE and rng.random() < 0.5
    )
    ops = GENERATORS[kind](rng)
    return FuzzCase(kind=kind, seed=seed, ops=ops, auth_first=auth_first)


# ---------------------------------------------------------------------------
# the in-process gateway harness
# ---------------------------------------------------------------------------


class _FuzzSocket:
    """asyncio.Transport stand-in: captures writes, honors pause/close,
    never touches a real socket."""

    def __init__(self, peer: tuple):
        self._peer = peer
        self._closing = False
        self.paused = False
        self.written: list = []

    def get_extra_info(self, name, default=None):
        if name == "peername":
            return self._peer
        return default

    def set_write_buffer_limits(self, high=None, low=None):
        pass

    def get_write_buffer_size(self) -> int:
        return 0

    def write(self, data: bytes) -> None:
        if not self._closing:
            self.written.append(data)

    def is_closing(self) -> bool:
        return self._closing

    def close(self) -> None:
        self._closing = True

    def abort(self) -> None:
        self._closing = True

    def pause_reading(self) -> None:
        self.paused = True

    def resume_reading(self) -> None:
        self.paused = False


class GatewayHarness:
    """A private, fully-booted gateway the fuzzer can hammer.

    Real everything: registries, FSMs, the GLOBAL channel with a SERVER
    owner, an honest authenticated client — only the sockets are fake.
    Bans are disabled (``max_failed_auth_attempts = max_fsm_disallowed =
    0``) because every fuzz peer would otherwise blacklist its synthetic
    /16 and turn the rest of the run into a no-op.
    """

    def __init__(self):
        self.violations: list[Violation] = []
        self._peer_serial = 0
        self.now_ns = 0
        self.mono = 0.0
        self._honest_written = 0

    # -- boot --------------------------------------------------------------

    def boot(self) -> None:
        from ..core import channel as channel_mod
        from ..core import connection as connection_mod
        from ..core import data as data_mod
        from ..core import ddos as ddos_mod
        from ..core import connection_recovery as recovery_mod
        from ..core import events
        from ..core.channel import init_channels
        from ..core.connection import init_connections
        from ..core.ddos import init_anti_ddos
        from ..core.overload import reset_overload
        from ..core.settings import (
            ChannelSettings,
            global_settings,
            reset_global_settings,
        )
        from ..core.tracing import recorder
        from ..core.types import ChannelType, ConnectionType
        from ..federation import reset_federation
        from ..spatial.controller import reset_spatial_controller

        channel_mod.reset_channels()
        connection_mod.reset_connections()
        data_mod.reset_registries()
        ddos_mod.reset_ddos()
        recovery_mod.reset_recovery()
        reset_spatial_controller()
        reset_global_settings()
        reset_overload()
        reset_federation()
        events.reset_all()

        global_settings.development = True
        global_settings.trace_enabled = False
        global_settings.slo_enabled = False
        global_settings.device_guard_enabled = False
        global_settings.balancer_enabled = False
        global_settings.federation_config = ""
        global_settings.max_failed_auth_attempts = 0
        global_settings.max_fsm_disallowed = 0
        global_settings.channel_settings = {
            ChannelType.GLOBAL: ChannelSettings(
                tick_interval_ms=10, default_fanout_interval_ms=20
            ),
        }
        recorder.configure(enabled=False)

        init_connections(
            os.path.join(REPO, "config", "server_authoritative_fsm.json"),
            os.path.join(REPO, "config", "client_authoritative_fsm.json"),
        )
        init_channels()
        init_anti_ddos()

        self._connection_mod = connection_mod
        self._settings = global_settings
        self.gch = channel_mod.get_global_channel()
        self.now_ns = 0
        self.mono = 0.0

        # GLOBAL owner: a SERVER conn fed through the real protocol path.
        self.master_proto, self.master_sock = self._open(
            ConnectionType.SERVER, ("10.255.255.1", 7777)
        )
        self.master = self.master_proto.conn
        self._feed(self.master_proto, _auth_frame("fuzz-master"))
        # Honest client: authenticates through the wire like any player.
        self.honest_proto, self.honest_sock = self._open(
            ConnectionType.CLIENT, ("10.255.255.2", 7778)
        )
        self.honest = self.honest_proto.conn
        self._feed(self.honest_proto, _auth_frame("fuzz-honest"))
        self._pump_sync()
        self.gch.set_owner(self.master)
        # Honest client subscribes to GLOBAL like a real player; the
        # census then also proves no hostile input can unsubscribe it.
        from ..protocol import control_pb2
        from ..core.types import MessageType

        self._feed(
            self.honest_proto,
            _frame(
                MessageType.SUB_TO_CHANNEL,
                control_pb2.SubscribedToChannelMessage(
                    connId=self.honest.id
                ).SerializeToString(),
            ),
        )
        self._pump_sync()
        assert self.honest in self.gch.subscribed_connections, (
            "harness boot failed: honest client not subscribed to GLOBAL"
        )
        self._honest_written = len(self.honest_sock.written)

    # -- plumbing ----------------------------------------------------------

    def _open(self, conn_type, peer):
        from ..core.server import _TcpServerProtocol

        proto = _TcpServerProtocol(conn_type)
        sock = _FuzzSocket(peer)
        proto.connection_made(sock)
        return proto, sock

    def open_peer(self):
        """A fresh hostile CLIENT socket with a unique synthetic address
        (unique so an IP ban from one case can never mute the next)."""
        from ..core.types import ConnectionType

        self._peer_serial += 1
        n = self._peer_serial
        peer = ("10.%d.%d.%d" % ((n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF), 40000)
        return self._open(ConnectionType.CLIENT, peer)

    def _feed(self, proto, data: bytes, case: Optional[FuzzCase] = None) -> None:
        """One data_received() call; an escaping exception IS the defect —
        on a live gateway it would reach the event loop."""
        if proto.transport.is_closing():
            return
        try:
            proto.data_received(data)
        except Exception:
            self.violations.append(
                Violation(
                    oracle="event_loop_exception",
                    detail=traceback.format_exc(limit=12),
                    case=case,
                )
            )
            # The socket is poisoned; a real loop would have died. Tear it
            # down so the rest of the run measures fresh state.
            try:
                proto.connection_lost(None)
            except Exception:
                logger.warning("teardown after violation failed", exc_info=True)

    def _pump_sync(self, case: Optional[FuzzCase] = None) -> None:
        """One deterministic gateway cycle: channel tick (drains ingest),
        fair flush pump, edge ladder tick. Escapes here are equally
        gateway-fatal — these run as bare loop tasks in production."""
        from ..core.edge import edge_tick

        self.now_ns += 10_000_000
        self.mono += 0.010
        try:
            self.gch.tick_once(self.now_ns)
            for conn in self._connection_mod.drain_pending_flush():
                conn.flush(fair=True)
                if conn.send_queue:
                    self._connection_mod.requeue_flush(conn)
            edge_tick()
        except Exception:
            self.violations.append(
                Violation(
                    oracle="event_loop_exception",
                    detail=traceback.format_exc(limit=12),
                    case=case,
                )
            )

    async def pump(self, case: Optional[FuzzCase] = None) -> None:
        self._pump_sync(case)
        # Let protocol _drain tasks (spawned under backpressure) run.
        await asyncio.sleep(0)

    # -- oracle ------------------------------------------------------------

    def check_envelopes(self, case: Optional[FuzzCase] = None) -> None:
        gs = self._settings
        for conn in list(self._connection_mod._all_connections.values()):
            q_len = len(conn.send_queue)
            q_bytes = conn.envelope.queue_bytes
            if q_len > gs.edge_send_queue_max_msgs or (
                q_bytes > gs.edge_send_queue_max_bytes
            ):
                self.violations.append(
                    Violation(
                        oracle="envelope",
                        detail="conn %d: %d msgs / %d bytes exceeds envelope"
                        % (conn.id, q_len, q_bytes),
                        case=case,
                    )
                )

    def check_census(self, case: Optional[FuzzCase] = None) -> None:
        from ..core.types import ConnectionState

        problems = []
        if self.master.is_closing():
            problems.append("GLOBAL owner closed")
        if self.honest.is_closing():
            problems.append("honest client closed")
        elif self.honest.state != ConnectionState.AUTHENTICATED:
            problems.append("honest client lost AUTHENTICATED state")
        elif self.honest not in self.gch.subscribed_connections:
            problems.append("honest client unsubscribed from GLOBAL")
        if self.gch.get_owner() is not self.master:
            problems.append("GLOBAL owner reassigned")
        for p in problems:
            self.violations.append(
                Violation(oracle="census", detail=p, case=case)
            )

    async def honest_roundtrip(self, case: Optional[FuzzCase] = None) -> None:
        """The honest client sends a user-space forward; it must reach the
        GLOBAL owner's socket — delivery intact under whatever abuse the
        current window applied."""
        before = len(self.master_sock.written)
        self._feed(self.honest_proto, _frame(100, b"fuzz-roundtrip"), case)
        for _ in range(4):
            await self.pump(case)
        if len(self.master_sock.written) <= before and not self.master.is_closing():
            self.violations.append(
                Violation(
                    oracle="roundtrip",
                    detail="honest user-space forward never reached the "
                    "GLOBAL owner",
                    case=case,
                )
            )

    # -- case driver -------------------------------------------------------

    async def run_case(self, case: FuzzCase) -> int:
        """Apply one hostile session; returns the number of NEW violations."""
        before = len(self.violations)
        proto, sock = self.open_peer()
        if proto.conn is None:  # admission refused (overload) — still legal
            return 0
        if case.auth_first:
            self._feed(proto, _auth_frame("fuzz-%d" % case.seed), case)
            await self.pump(case)
        for op in case.ops:
            if op[0] == "data":
                self._feed(proto, op[1], case)
            elif op[0] == "pump":
                await self.pump(case)
            elif op[0] == "close":
                try:
                    proto.connection_lost(None)
                except Exception:
                    self.violations.append(
                        Violation(
                            oracle="event_loop_exception",
                            detail=traceback.format_exc(limit=12),
                            case=case,
                        )
                    )
                break
        await self.pump(case)
        self.check_envelopes(case)
        self.check_census(case)
        # Hostile peer leaves; teardown must be clean too.
        if not sock.is_closing():
            try:
                proto.connection_lost(None)
            except Exception:
                self.violations.append(
                    Violation(
                        oracle="event_loop_exception",
                        detail=traceback.format_exc(limit=12),
                        case=case,
                    )
                )
        return len(self.violations) - before


# ---------------------------------------------------------------------------
# minimization + corpus
# ---------------------------------------------------------------------------


async def _still_fails(case: FuzzCase) -> bool:
    """Replay ``case`` against a FRESH gateway; True if any oracle trips."""
    h = GatewayHarness()
    h.boot()
    new = await h.run_case(case)
    return new > 0


async def minimize(case: FuzzCase, budget: int = 120) -> FuzzCase:
    """ddmin-lite: drop whole ops, then halve data payloads, keeping every
    step that still reproduces. Bounded by ``budget`` replays — corpus
    entries should be small, not provably minimal."""
    best = case
    runs = 0

    # Pass 1: remove ops one at a time (repeat until fixpoint).
    changed = True
    while changed and runs < budget:
        changed = False
        for i in range(len(best.ops) - 1, -1, -1):
            if len(best.ops) == 1:
                break
            trial = FuzzCase(
                kind=best.kind,
                seed=best.seed,
                ops=best.ops[:i] + best.ops[i + 1 :],
                auth_first=best.auth_first,
            )
            runs += 1
            if await _still_fails(trial):
                best = trial
                changed = True
            if runs >= budget:
                break

    # Pass 2: shrink each data op by halving from either end.
    for i, op in enumerate(best.ops):
        if op[0] != "data" or runs >= budget:
            continue
        data = op[1]
        step = len(data) // 2
        while step > 0 and runs >= 0 and runs < budget:
            shrunk = False
            for trial_data in (data[step:], data[:-step]):
                if not trial_data:
                    continue
                ops = list(best.ops)
                ops[i] = ("data", trial_data)
                trial = FuzzCase(
                    kind=best.kind, seed=best.seed, ops=ops,
                    auth_first=best.auth_first,
                )
                runs += 1
                if await _still_fails(trial):
                    best = trial
                    data = trial_data
                    shrunk = True
                    break
                if runs >= budget:
                    break
            if not shrunk:
                step //= 2
    return best


def save_case(case: FuzzCase, violation: Violation, corpus_dir: str = CORPUS_DIR) -> str:
    os.makedirs(corpus_dir, exist_ok=True)
    name = "%s_%s_%08x.json" % (violation.oracle, case.kind, case.seed)
    path = os.path.join(corpus_dir, name)
    obj = case.to_json()
    obj["oracle"] = violation.oracle
    obj["detail"] = violation.detail.strip().splitlines()[-1][:200]
    with open(path, "w") as f:  # tpulint: disable=async-blocking -- corpus files are tiny JSON and the fuzz harness owns its private loop; no gateway traffic rides it
        json.dump(obj, f, indent=1)
    return path


def load_corpus(corpus_dir: str = CORPUS_DIR) -> list:
    """(filename, FuzzCase) pairs, sorted for deterministic replay order."""
    if not os.path.isdir(corpus_dir):
        return []
    out = []
    for name in sorted(os.listdir(corpus_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(corpus_dir, name)) as f:  # tpulint: disable=async-blocking -- tiny JSON reads on the harness's private loop
            out.append((name, FuzzCase.from_json(json.load(f))))
    return out


def write_pinned_corpus(corpus_dir: str = CORPUS_DIR) -> list:
    """Write one canonical case per hostile family from fixed seeds.

    The committed corpus has two kinds of entry: *minimized defects* (from
    run_fuzz finding a real violation — the file records the oracle it
    tripped) and these *pinned sentinels* — inputs the gateway currently
    survives and must keep surviving. Both replay identically in tier-1:
    zero violations or the build is red. Regenerate with
    ``python -c "from channeld_tpu.chaos.fuzz import write_pinned_corpus;
    write_pinned_corpus()"`` after adding a family."""
    os.makedirs(corpus_dir, exist_ok=True)
    paths = []
    for kind in sorted(GENERATORS):
        # A fixed per-family seed keeps files byte-stable across runs.
        seed = int.from_bytes(kind.encode()[:4].ljust(4, b"\0"), "big")
        rng = Random(seed)
        case = FuzzCase(
            kind=kind,
            seed=seed,
            ops=GENERATORS[kind](rng),
            auth_first=kind in _AUTH_ALWAYS or kind in _AUTH_ELIGIBLE,
        )
        obj = case.to_json()
        obj["oracle"] = "pinned"
        obj["detail"] = "sentinel: the gateway survives this family today"
        path = os.path.join(corpus_dir, "pinned_%s.json" % kind)
        with open(path, "w") as f:  # tpulint: disable=async-blocking -- tiny JSON writes on the harness's private loop
            json.dump(obj, f, indent=1)
        paths.append(path)
    return paths


async def replay_corpus(corpus_dir: str = CORPUS_DIR) -> dict:
    """Replay every committed corpus case against a fresh gateway each —
    the tier-1 regression gate. Returns {file: n_violations}; all zeros
    means every past defect is still fixed."""
    results = {}
    for name, case in load_corpus(corpus_dir):
        h = GatewayHarness()
        h.boot()
        results[name] = await h.run_case(case)
    return results


# ---------------------------------------------------------------------------
# the main fuzz loop
# ---------------------------------------------------------------------------


async def run_fuzz(
    iterations: int,
    seed: int = 0,
    corpus_dir: Optional[str] = None,
    do_minimize: bool = True,
    roundtrip_every: int = 512,
    progress: Optional[Callable[[int, int], None]] = None,
) -> dict:
    """Drive ``iterations`` seeded hostile sessions against one live
    gateway; returns a JSON-able report. The gateway is rebooted after any
    violation (its state is suspect) and otherwise lives across the whole
    run — leaks and cross-connection corruption only show up that way."""
    h = GatewayHarness()
    h.boot()
    report = {
        "iterations": iterations,
        "seed": seed,
        "kinds": {},
        "violations": [],
        "corpus_files": [],
    }
    for i in range(iterations):
        case = make_case(seed, i)
        report["kinds"][case.kind] = report["kinds"].get(case.kind, 0) + 1
        new = await h.run_case(case)
        if i % roundtrip_every == roundtrip_every - 1 and not new:
            await h.honest_roundtrip(case)
            new = len([v for v in h.violations if v.case is case])
        if new:
            fresh = h.violations[-1]
            min_case = case
            if do_minimize and await _still_fails(case):
                min_case = await minimize(case)
            report["violations"].append(
                {
                    "iteration": i,
                    "oracle": fresh.oracle,
                    "kind": case.kind,
                    "seed": case.seed,
                    "detail": fresh.detail.strip().splitlines()[-1][:300],
                    "ops": len(min_case.ops),
                }
            )
            if corpus_dir is not None:
                report["corpus_files"].append(
                    save_case(min_case, fresh, corpus_dir)
                )
            h = GatewayHarness()  # suspect state: start clean
            h.boot()
        if progress is not None and (i + 1) % 1000 == 0:
            progress(i + 1, len(report["violations"]))
    report["total_violations"] = len(report["violations"])
    return report
