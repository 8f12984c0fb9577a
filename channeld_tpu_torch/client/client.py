"""Client SDK: a synchronous socket client for game clients/servers.

Capability parity with the reference client library (ref: pkg/client/client.go):
message-handler registry, stub-id RPC callbacks, incoming/outgoing queues
pumped by ``tick()``, TCP and WebSocket dialing, default handlers that
track subscribed/created/listed channels. Blocking sockets + a tick pump
keep it embeddable in a game loop; an asyncio wrapper is trivial on top.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional
from urllib.parse import urlparse

from ..protocol import (
    FrameDecoder,
    MAX_PACKET_SIZE,
    control_pb2,
    encode_frame,
    spatial_pb2,
    wire_pb2,
)
from ..core.types import BroadcastType, CompressionType, MessageType
from ..utils.logger import get_logger

logger = get_logger("client")

MessageHandler = Callable[["Client", int, object], None]
# (client, channel_id, message)


@dataclass
class _MessageEntry:
    template: type
    handlers: list[MessageHandler] = field(default_factory=list)


class Client:
    """(ref: ChanneldClient)."""

    def __init__(self, addr: str, connect_timeout: float = 5.0):
        self.id = 0
        self.compression_type = CompressionType.NO_COMPRESSION
        self.subscribed_channels: set[int] = set()
        self.created_channels: set[int] = set()
        self.listed_channels: set[int] = set()
        self.connected = False
        # Client-side decode accepts >64KB server packets via the 3-byte
        # size escape (ref: client.go:191-196; the server cap stays 64KB).
        self._decoder = FrameDecoder(extended_size=True)
        self._incoming: list = []  # (msg, channel_id, stub_id, handlers)
        self._outgoing: list[wire_pb2.MessagePack] = []
        self._lock = threading.Lock()
        self._message_map: dict[int, _MessageEntry] = {}
        self._stub_callbacks: dict[int, MessageHandler] = {0: lambda c, ch, m: None}
        self._next_stub = 1

        self._rudp = None
        if addr.startswith("ws"):
            import websockets.sync.client as ws_client

            self._ws = ws_client.connect(addr, max_size=1 << 20)
            self._sock = None
        elif addr.startswith(("rudp://", "kcp://")):
            netloc = urlparse(addr).netloc
            host, _, port = netloc.rpartition(":")
            if addr.startswith("kcp://"):
                # Real KCP wire protocol (kcp-go interop class).
                from ..core.kcp import KcpClient

                self._rudp = KcpClient(
                    host or "127.0.0.1", int(port), connect_timeout
                )
            else:
                from ..core.rudp import RudpClient

                self._rudp = RudpClient(
                    host or "127.0.0.1", int(port), connect_timeout
                )
            self._ws = None
            self._sock = None
        else:
            if "://" in addr:
                addr = urlparse(addr).netloc
            host, _, port = addr.rpartition(":")
            self._sock = socket.create_connection(
                (host or "127.0.0.1", int(port)), timeout=connect_timeout
            )
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._ws = None
        self.connected = True

        self.set_message_entry(
            MessageType.AUTH, control_pb2.AuthResultMessage, _handle_auth
        )
        self.set_message_entry(
            MessageType.CREATE_CHANNEL,
            control_pb2.CreateChannelResultMessage,
            _handle_create_channel,
        )
        self.set_message_entry(
            MessageType.REMOVE_CHANNEL,
            control_pb2.RemoveChannelMessage,
            _handle_remove_channel,
        )
        self.set_message_entry(
            MessageType.SUB_TO_CHANNEL,
            control_pb2.SubscribedToChannelResultMessage,
            _handle_sub,
        )
        self.set_message_entry(
            MessageType.UNSUB_FROM_CHANNEL,
            control_pb2.UnsubscribedFromChannelResultMessage,
            _handle_unsub,
        )
        self.set_message_entry(
            MessageType.LIST_CHANNEL, control_pb2.ListChannelResultMessage, _handle_list
        )
        self.set_message_entry(
            MessageType.CHANNEL_DATA_UPDATE, control_pb2.ChannelDataUpdateMessage
        )
        self.set_message_entry(
            MessageType.CREATE_SPATIAL_CHANNEL,
            spatial_pb2.CreateSpatialChannelsResultMessage,
        )
        self.set_message_entry(
            MessageType.CREATE_ENTITY_CHANNEL,
            control_pb2.CreateChannelResultMessage,
        )
        self.set_message_entry(
            MessageType.SPATIAL_CHANNELS_READY, spatial_pb2.SpatialChannelsReadyMessage
        )
        self.set_message_entry(
            MessageType.SPATIAL_REGIONS_UPDATE, spatial_pb2.SpatialRegionsUpdateMessage
        )
        self.set_message_entry(
            MessageType.QUERY_SPATIAL_CHANNEL,
            spatial_pb2.QuerySpatialChannelResultMessage,
        )
        self.set_message_entry(
            MessageType.CHANNEL_DATA_HANDOVER, spatial_pb2.ChannelDataHandoverMessage
        )
        self.set_message_entry(
            MessageType.RECOVERY_CHANNEL_DATA, control_pb2.ChannelDataRecoveryMessage
        )
        self.set_message_entry(MessageType.RECOVERY_END, control_pb2.EndRecoveryMessage)
        self.set_message_entry(
            MessageType.CHANNEL_OWNER_LOST, control_pb2.ChannelOwnerLostMessage
        )
        self.set_message_entry(
            MessageType.CHANNEL_OWNER_RECOVERED,
            control_pb2.ChannelOwnerRecoveredMessage,
        )


    # ---- registry ----------------------------------------------------------

    def set_message_entry(self, msg_type: int, template: type, *handlers) -> None:
        self._message_map[msg_type] = _MessageEntry(template, list(handlers))

    def add_message_handler(self, msg_type: int, *handlers) -> None:
        entry = self._message_map.get(msg_type)
        if entry is None:
            raise KeyError(f"no message entry for type {msg_type}")
        entry.handlers.extend(handlers)

    # ---- io ------------------------------------------------------------

    def auth(self, login_token: str = "", pit: str = "") -> None:
        self.send(
            0,
            BroadcastType.NO_BROADCAST,
            MessageType.AUTH,
            control_pb2.AuthMessage(playerIdentifierToken=pit, loginToken=login_token),
        )

    def send(
        self,
        channel_id: int,
        broadcast: int,
        msg_type: int,
        msg,
        callback: Optional[MessageHandler] = None,
    ) -> None:
        self.send_raw(channel_id, broadcast, msg_type, msg.SerializeToString(), callback)

    def send_raw(
        self,
        channel_id: int,
        broadcast: int,
        msg_type: int,
        msg_body: bytes,
        callback: Optional[MessageHandler] = None,
    ) -> None:
        stub_id = 0
        if callback is not None:
            stub_id = self._next_stub
            self._next_stub = self._next_stub % 0xFFFF + 1
            self._stub_callbacks[stub_id] = callback
        with self._lock:
            self._outgoing.append(
                wire_pb2.MessagePack(
                    channelId=channel_id,
                    broadcast=broadcast,
                    stubId=stub_id,
                    msgType=msg_type,
                    msgBody=msg_body,
                )
            )

    def receive(self, timeout: float = 0.0) -> None:
        """Read whatever is on the wire and queue decoded messages."""
        data = self._read(timeout)
        if not data:
            return
        for packet in self._decoder.decode_packets(data):
            for mp in packet.messages:
                entry = self._message_map.get(mp.msgType)
                if entry is None:
                    logger.warning("no message entry for incoming type %d", mp.msgType)
                    continue
                msg = entry.template()
                msg.ParseFromString(mp.msgBody)
                self._incoming.append((msg, mp.channelId, mp.stubId, entry.handlers))

    def tick(self, timeout: float = 0.0) -> None:
        """Pump receive + dispatch + flush (ref: client.go:246-276)."""
        self.receive(timeout)
        while self._incoming:
            msg, channel_id, stub_id, handlers = self._incoming.pop(0)
            for handler in handlers:
                handler(self, channel_id, msg)
            if stub_id:
                callback = self._stub_callbacks.pop(stub_id, None)
                if callback is not None:
                    callback(self, channel_id, msg)
        self.flush()

    def flush(self) -> None:
        from ..protocol import FramingError

        with self._lock:
            pending, self._outgoing = self._outgoing, []
        if not pending:
            return
        packet = wire_pb2.Packet()
        size = 0
        for mp in pending:
            msg_size = mp.ByteSize() + 6
            if msg_size > MAX_PACKET_SIZE:
                logger.warning(
                    "dropping oversized message (type %d, %d bytes)",
                    mp.msgType, msg_size,
                )
                continue
            size += msg_size
            if packet.messages and size > MAX_PACKET_SIZE:
                self._write_packet(packet)
                packet = wire_pb2.Packet()
                size = msg_size
            packet.messages.append(mp)
        if packet.messages:
            try:
                self._write_packet(packet)
            except FramingError:
                logger.exception("failed to flush packet")

    def _write_packet(self, packet: wire_pb2.Packet) -> None:
        frame = encode_frame(packet.SerializeToString(), int(self.compression_type))
        try:
            if self._rudp is not None:
                self._rudp.send(frame)
            elif self._ws is not None:
                self._ws.send(frame)
            else:
                self._sock.sendall(frame)
        except Exception:
            # BrokenPipe / ConnectionClosed / ICMP unreachable: peer is gone.
            self.connected = False

    def _read(self, timeout: float) -> bytes:
        if self._rudp is not None:
            data = self._rudp.recv(timeout)
            if self._rudp.session.closed:
                self.connected = False
            return data
        if self._ws is not None:
            try:
                msg = self._ws.recv(timeout=timeout)
            except TimeoutError:
                return b""
            except Exception:  # ConnectionClosed and friends
                self.connected = False
                return b""
            return msg if isinstance(msg, bytes) else msg.encode()
        self._sock.settimeout(timeout if timeout > 0 else 0.000001)
        try:
            data = self._sock.recv(1 << 17)
        except (socket.timeout, BlockingIOError):
            return b""
        except OSError:
            self.connected = False
            return b""
        if data == b"":
            # recv() returning empty without a timeout means peer EOF.
            self.connected = False
        return data

    def wait_for(self, msg_type: int, timeout: float = 5.0):
        """Convenience: tick until a message of ``msg_type`` arrives."""
        import time as _time

        box: list = []

        def _catch(client, channel_id, m):
            box.append((channel_id, m))

        self.add_message_handler(msg_type, _catch)
        try:
            end = _time.time() + timeout
            while not box and _time.time() < end:
                self.tick(timeout=0.05)
        finally:
            self._message_map[msg_type].handlers.remove(_catch)
        if not box:
            raise TimeoutError(f"no message of type {msg_type} within {timeout}s")
        return box[0]

    def disconnect(self) -> None:
        self.connected = False
        try:
            if self._rudp is not None:
                self._rudp.close()
            elif self._ws is not None:
                self._ws.close()
            else:
                self._sock.close()
        except OSError:
            pass

    def is_connected(self) -> bool:
        return self.connected


# ---- default handlers (ref: client.go handleAuth etc.) --------------------


def _handle_auth(client: Client, channel_id: int, msg) -> None:
    if msg.result == control_pb2.AuthResultMessage.SUCCESSFUL and client.id == 0:
        client.id = msg.connId
        client.compression_type = CompressionType(msg.compressionType)


def _handle_create_channel(client: Client, channel_id: int, msg) -> None:
    if msg.ownerConnId == client.id:
        client.created_channels.add(msg.channelId)


def _handle_remove_channel(client: Client, channel_id: int, msg) -> None:
    client.subscribed_channels.discard(msg.channelId)
    client.created_channels.discard(msg.channelId)
    client.listed_channels.discard(msg.channelId)


def _handle_sub(client: Client, channel_id: int, msg) -> None:
    if msg.connId == client.id:
        client.subscribed_channels.add(channel_id)


def _handle_unsub(client: Client, channel_id: int, msg) -> None:
    if msg.connId == client.id:
        client.subscribed_channels.discard(channel_id)


def _handle_list(client: Client, channel_id: int, msg) -> None:
    client.listed_channels = {info.channelId for info in msg.channels}
