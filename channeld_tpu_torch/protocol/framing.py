"""Packet framing: the 5-byte tag + optional snappy body.

Wire-spec parity with the reference transport
(ref: pkg/channeld/connection.go:445-541 read side, :683-697 write side):

    byte 0: 'C' (0x43)
    byte 1: 'H' (0x48)
    byte 2: body size high byte     (written over 'N')
    byte 3: body size low byte      (written over 'L')
    byte 4: CompressionType (0 none, 1 snappy)

Body is a serialized ``chtpu.Packet``, at most 0xFFFF bytes after
compression. A decoder that sees a bad magic or oversized length must
drop the connection, mirroring the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import snappy
from .wire_pb2 import Packet

try:  # native C++ codec (scripts/build_native.sh); None -> pure Python
    from ..native import codec as _native
except ImportError:
    _native = None

HEADER_SIZE = 5
MAX_PACKET_SIZE = 0xFFFF
_MAGIC0 = 0x43  # 'C'
_MAGIC1 = 0x48  # 'H'


class FramingError(Exception):
    """Fatal stream error; the connection must be closed."""


def encode_frame(body: bytes, compression: int = 0) -> bytes:
    """Wrap a serialized Packet into one wire frame.

    The size cap applies to the *uncompressed* body (the reference caps the
    marshaled Packet at 64KB before compressing, connection.go:626-714), so
    encode and decode agree on what a legal frame is: the decoder's
    decompression-bomb cap can then assume no honest peer produced a frame
    that inflates past a small multiple of MAX_PACKET_SIZE."""
    if len(body) > MAX_PACKET_SIZE:
        raise FramingError(f"packet oversized: {len(body)}")
    if _native is not None:
        try:
            return _native.encode_frame(body, compression)
        except _native.CodecError as e:
            raise FramingError(str(e)) from None
    if compression == 1:
        compressed = snappy.compress(body)
        # Fall back to raw when compression doesn't help (and to keep the
        # size cap meaningful for small payloads).
        if len(compressed) < len(body):
            body = compressed
        else:
            compression = 0
    if len(body) > MAX_PACKET_SIZE:
        raise FramingError(f"packet oversized: {len(body)}")
    return bytes((_MAGIC0, _MAGIC1, (len(body) >> 8) & 0xFF, len(body) & 0xFF,
                  compression)) + body


def encode_packet(packet: Packet, compression: int = 0) -> bytes:
    return encode_frame(packet.SerializeToString(), compression)


@dataclass
class FrameDecoder:
    """Incremental frame decoder for a byte stream.

    ``feed`` buffers arbitrary chunks and yields complete decompressed
    packet bodies. Fragmented reads are counted for metrics parity with
    the reference's fragmentedPacketCount.
    """

    _buf: bytearray = field(default_factory=bytearray)
    fragmented_count: int = 0
    # Last compression type seen from the peer; the send path mirrors it.
    peer_compression: int = 0
    # Client-side mode: accept the reference client's 3-byte size escape
    # (tag byte 1 != 'H' carries the size's high byte, client.go:191-196)
    # so server->client packets over 64KB decode. The gateway's own
    # decoder stays strict — the reference server never WRITES >64KB and
    # treats an escaped tag as hostile. Python path only (the native
    # codec implements the strict gateway wire).
    extended_size: bool = False

    def feed(self, data: bytes) -> list[bytes]:
        # Eager, not a generator: data must land in the buffer even when
        # the caller discards the return value (no frames yet).
        self._buf.extend(data)
        if self.extended_size:
            out: list[bytes] = []
            while True:
                body = self._next_frame()
                if body is None:
                    return out
                out.append(body)
        if _native is not None:
            try:
                # bytearray passes the buffer protocol: no copy.
                frames, consumed = _native.decode_frames(self._buf)
            except _native.CodecError as e:
                raise FramingError(str(e)) from None
            del self._buf[:consumed]
            if self._buf:
                self.fragmented_count += 1
            out = []
            for body, ct in frames:
                if ct == 1:
                    self.peer_compression = 1
                out.append(body)
            return out
        out: list[bytes] = []
        while True:
            body = self._next_frame()
            if body is None:
                return out
            out.append(body)

    def _next_frame(self) -> Optional[bytes]:
        buf = self._buf
        if len(buf) < HEADER_SIZE:
            if buf:
                self.fragmented_count += 1
            return None
        if buf[0] != _MAGIC0:
            raise FramingError(f"invalid tag: {bytes(buf[:4])!r}")
        if self.extended_size and buf[1] != _MAGIC1:
            # 3-byte size escape (client.go:191-196): byte 1 carries the
            # topmost size byte, allowing server->client packets past
            # 64KB. Two wire-inherited quirks: (a) the reference client
            # treats a literal 'N' in byte 2 as zero — a misparse for
            # honest ~20KB frames whose size high byte IS 0x4E;
            # deliberately not inherited. (b) a topmost byte of 'H'
            # (0x48) is indistinguishable from the strict 2-byte form,
            # so escaped sizes 0x480000-0x48FFFF (~4.7MB) are
            # unrepresentable in this tag encoding — writers must pad
            # past the hole; sizes at/above it are rejected here rather
            # than silently desyncing the stream.
            size = (buf[1] << 16) | (buf[2] << 8) | buf[3]
            if size >= 0x480000:
                raise FramingError(
                    f"extended frame size {size} in/past the 0x48 tag "
                    "collision hole"
                )
        else:
            if buf[1] != _MAGIC1:
                raise FramingError(f"invalid tag: {bytes(buf[:4])!r}")
            size = (buf[2] << 8) | buf[3]
        if size == 0:
            raise FramingError("zero-size frame")
        full = HEADER_SIZE + size
        if len(buf) < full:
            self.fragmented_count += 1
            return None
        ct = buf[4]
        body = bytes(buf[HEADER_SIZE:full])
        del buf[:full]
        if ct == 1:
            self.peer_compression = 1
            try:
                if self.extended_size:
                    # The strict cap (a small multiple of 64KB) is the
                    # gateway's decompression-bomb guard; extended mode
                    # exists to accept large server packets, so the cap
                    # scales with the extended size ceiling instead.
                    body = snappy.uncompress(body, max_len=0x480000 * 4)
                else:
                    body = snappy.uncompress(body)
            except ValueError as e:
                # Corrupt or bomb-sized snappy data is a stream-fatal
                # framing condition, not a caller error.
                raise FramingError(str(e)) from None
        elif ct != 0:
            # Unknown compression tags are ignored (treated as raw),
            # mirroring the reference's CompressionType_name check.
            pass
        return body

    def decode_packets(self, data: bytes) -> list[Packet]:
        out = []
        for body in self.feed(data):
            p = Packet()
            p.ParseFromString(body)
            out.append(p)
        return out
