"""The sidecar's wire messages, written and read by the benchmark itself.

A hand-written encoder of ``ConfigRequest`` and ``StepRequest`` and a decoder
of ``StepResponse`` in the protobuf wire format of
``channeld_tpu_torch/ops/service.proto`` (package ``chtpu.ops``). The
benchmark makes its requests and judges the responses without the program's
generated classes; the program parses and serialises with its own, as its
gRPC handler does. Fields with a zero value are written anyway (valid
protobuf; a parser reads them as the default they equal). The entity
updates, which are most of a request's bytes, are encoded with numpy.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

_LEN = 2
_VARINT = 0
_I32 = 5
_I64 = 1


def varint(value: int) -> bytes:
    """One varint; a negative int32/int64 as its 64-bit two's complement."""
    v = int(value) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _LEN) + varint(len(payload)) + payload


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, _VARINT) + varint(value)


def _f32_field(field: int, value: float) -> bytes:
    return _tag(field, _I32) + struct.pack("<f", value)


def _f64_field(field: int, value: float) -> bytes:
    return _tag(field, _I64) + struct.pack("<d", value)


def varints_np(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(bytes u8[n, 10], lengths int[n]) of the varints of non-negative
    integers ``values``."""
    x = np.asarray(values, dtype=np.uint64).copy()
    n = x.shape[0]
    out = np.zeros((n, 10), np.uint8)
    lens = np.ones(n, np.int64)
    for i in range(10):
        low = (x & np.uint64(0x7F)).astype(np.uint8)
        x >>= np.uint64(7)
        more = x != 0
        out[:, i] = low | (more.astype(np.uint8) << 7)
        lens += more
        if not more.any():
            break
    return out, lens


def packed_varints(values) -> bytes:
    """The payload of a packed repeated varint field."""
    values = np.asarray(values, dtype=np.uint64)
    if values.size == 0:
        return b""
    mat, lens = varints_np(values)
    mask = np.arange(10)[None, :] < lens[:, None]
    return mat[mask].tobytes()


def entity_updates(ids: np.ndarray, pos: np.ndarray) -> bytes:
    """Field 1 of StepRequest, repeated EntityPosition, for every row:
    ``08 id 15 x 1d y 25 z`` inside ``0a len``."""
    n = ids.shape[0]
    if n == 0:
        return b""
    vint, vlen = varints_np(ids.astype(np.uint64))
    if vlen.max() > 5:
        raise ValueError("entity ids are uint32")
    inner = 1 + vlen + 15
    width = 2 + 1 + 5 + 15
    mat = np.zeros((n, width), np.uint8)
    mask = np.zeros((n, width), bool)
    mat[:, 0] = 0x0A
    mat[:, 1] = inner  # < 128: one length byte
    mat[:, 2] = 0x08
    mask[:, :3] = True
    mat[:, 3:8] = vint[:, :5]
    mask[:, 3:8] = np.arange(5)[None, :] < vlen[:, None]
    xyz = np.ascontiguousarray(pos, dtype="<f4").view(np.uint8).reshape(n, 12)
    for k, tag in enumerate((0x15, 0x1D, 0x25)):
        col = 8 + 5 * k
        mat[:, col] = tag
        mat[:, col + 1: col + 5] = xyz[:, 4 * k: 4 * k + 4]
    mask[:, 8:] = True
    return mat[mask].tobytes()


class Query(NamedTuple):
    conn: int
    kind: int
    cx: float
    cz: float
    ex: float
    ez: float
    dx: float
    dz: float
    angle: float
    spot_x: tuple = ()
    spot_z: tuple = ()
    spot_dists: tuple = ()


def _query(q: Query) -> bytes:
    body = (_varint_field(1, q.conn) + _varint_field(2, q.kind)
            + b"".join(_f32_field(f, v) for f, v in zip(
                range(3, 10), (q.cx, q.cz, q.ex, q.ez, q.dx, q.dz, q.angle))))
    if q.spot_x:
        body += _len_field(10, np.asarray(q.spot_x, "<f4").tobytes())
    if q.spot_z:
        body += _len_field(11, np.asarray(q.spot_z, "<f4").tobytes())
    if q.spot_dists:
        body += _len_field(12, packed_varints(q.spot_dists))
    return _len_field(3, body)


def step_request(step) -> bytes:
    """A StepRequest's bytes from one step of generated traffic (the
    fields of ``gen.sidecar_load.Step``)."""
    parts = [entity_updates(step.upd_ids, step.upd_pos)]
    if len(step.removed_entities):
        parts.append(_len_field(2, packed_varints(step.removed_entities)))
    parts.extend(_query(q) for q in step.queries)
    if len(step.removed_conns):
        parts.append(_len_field(4, packed_varints(step.removed_conns)))
    for sid, interval, first in zip(step.add_sub_ids.tolist(), step.add_sub_interval.tolist(),
                                    step.add_sub_first.tolist()):
        parts.append(_len_field(5, _varint_field(1, sid) + _varint_field(2, interval)
                                + _varint_field(3, first)))
    if len(step.remove_subs):
        parts.append(_len_field(6, packed_varints(step.remove_subs)))
    parts.append(_varint_field(7, step.now_ms))
    parts.append(_varint_field(8, int(step.full)))
    return b"".join(parts)


def config_request(grid: dict, entity_capacity: int, query_capacity: int,
                   sub_capacity: int) -> bytes:
    """A ConfigRequest's bytes (no mesh)."""
    return (_f64_field(1, grid["offset_x"]) + _f64_field(2, grid["offset_z"])
            + _f64_field(3, grid["cell_w"]) + _f64_field(4, grid["cell_h"])
            + _varint_field(5, grid["cols"]) + _varint_field(6, grid["rows"])
            + _varint_field(7, entity_capacity) + _varint_field(8, query_capacity)
            + _varint_field(9, sub_capacity) + _varint_field(10, 0) + _varint_field(11, 0))


# ---- reading a StepResponse ---------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, i
        shift += 7


def decode_packed(buf: bytes) -> np.ndarray:
    """A packed varint payload as int64 values (vectorised)."""
    a = np.frombuffer(buf, np.uint8)
    if a.size == 0:
        return np.zeros(0, np.int64)
    ends = np.nonzero(a < 0x80)[0]
    starts = np.concatenate(([0], ends[:-1] + 1))
    pos = np.arange(a.size) - np.repeat(starts, ends - starts + 1)
    vals = (a & 0x7F).astype(np.uint64) << (np.uint64(7) * pos.astype(np.uint64))
    return np.add.reduceat(vals, starts).astype(np.int64)


def _fields(buf: bytes):
    """(field, wire type, value or payload bytes) of each field of one
    message."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            v, i = _read_varint(buf, i)
            yield field, wire, v
        elif wire == _LEN:
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i: i + ln]
            i += ln
        elif wire == _I32:
            yield field, wire, buf[i: i + 4]
            i += 4
        elif wire == _I64:
            yield field, wire, buf[i: i + 8]
            i += 8
        else:
            raise ValueError(f"wire type {wire} in a StepResponse")


def _repeated_u32(wire, value, into: list) -> None:
    if wire == _LEN:
        into.append(decode_packed(value))
    else:
        into.append(np.array([value], np.int64))


def _cat(parts: list) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


class Decision(NamedTuple):
    """One StepResponse, read back: handover rows int64[K, 3] (entity,
    src, dst), the count, cell counts, {conn: (cells, dists)}, due ids,
    the engine's clock and the error text."""

    handovers: np.ndarray
    handover_count: int
    cell_counts: np.ndarray
    interests: dict
    due_sub_ids: np.ndarray
    now_ms: int
    error: str


def step_response(buf: bytes) -> Decision:
    rows, counts, due, interests = [], [], [], {}
    count = now = 0
    error = ""
    for field, wire, value in _fields(buf):
        if field == 1:
            row = [0, 0, 0]
            for f, _, v in _fields(value):
                if 1 <= f <= 3:
                    row[f - 1] = v
            rows.append(row)
        elif field == 2:
            count = value
        elif field == 3:
            _repeated_u32(wire, value, counts)
        elif field == 4:
            conn, cells, dists = 0, [], []
            for f, w, v in _fields(value):
                if f == 1:
                    conn = v
                elif f == 2:
                    _repeated_u32(w, v, cells)
                elif f == 3:
                    _repeated_u32(w, v, dists)
            interests[conn] = (_cat(cells), _cat(dists))
        elif field == 5:
            _repeated_u32(wire, value, due)
        elif field == 6:
            now = value - (1 << 64) if value >= 1 << 63 else value
        elif field == 7:
            error = bytes(value).decode("utf-8", "replace")
    handovers = np.array(rows, np.int64).reshape(-1, 3)
    return Decision(handovers, count, _cat(counts), interests, _cat(due), now, error)
