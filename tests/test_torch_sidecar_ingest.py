"""The sidecar's columnar ingest (``native/step_columns.cc``,
``SpatialEngine.update_entities``, ``SpatialDecisionServicer._decide``).

The decoder is held bit for bit to what protobuf's own parser reads from
the same wire bytes, hand-built to reach each of the wire format's rules;
``update_entities`` to the per-entity ``update_entity`` calls it replaces,
on every host table they touch; and the whole sidecar with the decoder to
one with the decoder withheld, which reads each update's fields in Python,
step by step.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace

import numpy as np
import pytest
from google.protobuf.message import DecodeError

from channeld_tpu_torch import native
from channeld_tpu_torch.ops import service
from channeld_tpu_torch.ops.engine import SpatialEngine
from channeld_tpu_torch.ops.service_pb2 import ConfigRequest, StepRequest
from channeld_tpu_torch.ops.spatial_ops import AOI_SPHERE, GridSpec
from test_torch_service import CONFIG, step_requests


@pytest.fixture(scope="module")
def decode():
    dec = native.load_step_columns()
    if dec is None:
        pytest.skip("g++ cannot build native/step_columns.cc here")
    return dec


# ---- wire bytes by hand ---------------------------------------------------


def varint(v: int, width: int = 0) -> bytes:
    """``v`` as a varint; ``width`` pads it with continuation bytes."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v or len(out) + 1 < width:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint(field << 3 | wire)


def vfield(field: int, v: int, width: int = 0) -> bytes:
    return tag(field, 0) + varint(v, width)


def ffield(field: int, bits: int) -> bytes:
    """A fixed32 field holding the 32 bits ``bits``."""
    return tag(field, 5) + struct.pack("<I", bits)


def f32(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def ldelim(field: int, body: bytes) -> bytes:
    return tag(field, 2) + varint(len(body)) + body


def update(*fields: bytes) -> bytes:
    """A StepRequest field 1 (one EntityPosition) of the given fields."""
    return ldelim(1, b"".join(fields))


ONE, TWO = f32(1.0), f32(2.0)
QNAN_A, QNAN_B = 0x7FC01234, 0xFFC00001  # quiet NaNs with payloads
SNAN = (0x7F800001, 0xFF800002, 0x7FBFFFFF)  # signalling NaNs
QUIETED = tuple(b | 0x00400000 for b in SNAN)
UNKNOWN = (vfield(9, 77) + ldelim(10, b"\x01\x02\x03") + tag(11, 1) + b"\0" * 8
           + tag(12, 3) + vfield(1, 5) + ffield(2, ONE) + tag(12, 4))

WIRE_CASES = {
    "one_in_order": update(vfield(1, 7), ffield(2, ONE), ffield(3, TWO), ffield(4, ONE)),
    "fields_reordered": update(ffield(4, ONE), ffield(2, TWO), vfield(1, 9), ffield(3, ONE))
    + update(ffield(3, TWO), vfield(1, 10), ffield(4, TWO), ffield(2, ONE)),
    "id_and_y_absent": update(ffield(2, ONE), ffield(4, TWO)) + update() + update(vfield(1, 3)),
    "unknown_fields": vfield(7, 1000) + ldelim(3, vfield(1, 4)) + update(
        UNKNOWN, vfield(1, 11), ffield(2, TWO)) + ldelim(2, varint(5) + varint(6))
    + tag(13, 3) + vfield(1, 1) + tag(13, 4) + update(vfield(1, 12), UNKNOWN, ffield(3, ONE))
    + vfield(8, 1),
    "wire_type_not_declared": update(ffield(1, 99), vfield(2, 5), vfield(1, 13))
    + vfield(1, 14) + tag(1, 3) + tag(1, 4) + tag(1, 1) + b"\0" * 8,
    "scalar_repeated_in_a_submessage": update(vfield(1, 1), ffield(2, ONE), vfield(1, 15),
                                              ffield(2, TWO), ffield(2, f32(3.5))),
    "ids_past_2_28": update(vfield(1, 1 << 28)) + update(vfield(1, (1 << 31) + 5))
    + update(vfield(1, (1 << 32) - 1)) + update(vfield(1, (1 << 64) - 1))
    + update(vfield(1, (1 << 32) + 7)) + update(vfield(1, 16, width=10)),
    "signed_zero_and_nan_payloads": update(vfield(1, 17), ffield(2, 0x80000000),
                                           ffield(3, QNAN_A), ffield(4, QNAN_B))
    + update(vfield(1, 18), ffield(2, 0x7F800000), ffield(3, 0xFF800000),
             ffield(4, f32(1e20))),
    "signalling_nan_quieted": update(vfield(1, 19), *(ffield(2 + i, b) for i, b in enumerate(SNAN))),
    "no_updates": vfield(7, 33) + ldelim(2, varint(1)),
    "empty": b"",
    "malformed_truncated_varint": update(vfield(1, 5))[:-1] + b"\x08\x80",
    "malformed_length_past_the_end": tag(1, 2) + varint(40) + vfield(1, 2),
    "malformed_in_a_submessage": ldelim(1, tag(2, 5) + b"\0\0"),
    "malformed_wire_type_7": update(vfield(1, 1)) + tag(3, 7),
    "malformed_end_group_unopened": update(tag(5, 4)),
    "malformed_varint_of_11_bytes": update(vfield(1, 1, width=11)),
    "malformed_field_0": update(vfield(1, 1)) + vfield(0, 1),
    "malformed_group_end_mismatched": update(tag(6, 3) + tag(7, 4)),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_decoder_reads_what_protobuf_parses(decode, case):
    """Each case's columns equal, bit for bit, protobuf's parse of the same
    bytes as Python reads it (a signalling NaN comes out quiet); bytes
    protobuf refuses decode to None (the library's -1)."""
    buf = WIRE_CASES[case]
    try:
        msg = StepRequest.FromString(buf)
    except DecodeError:
        assert case.startswith("malformed"), case
        assert decode(buf, 64) is None
        return
    assert not case.startswith("malformed"), case
    got = decode(buf, len(msg.updates))
    assert got is not None
    ids, xyz = got
    want_ids = np.array([u.entityId for u in msg.updates], np.uint32)
    want_xyz = np.array([(u.x, u.y, u.z) for u in msg.updates], np.float32).reshape(-1, 3)
    assert ids.dtype == np.uint32 and xyz.dtype == np.float32 and xyz.shape == (len(ids), 3)
    assert np.array_equal(ids, want_ids)
    assert np.array_equal(xyz.view(np.uint32), want_xyz.view(np.uint32))
    if case == "signed_zero_and_nan_payloads":
        assert xyz.view(np.uint32)[0].tolist() == [0x80000000, QNAN_A, QNAN_B]
    if case == "signalling_nan_quieted":
        assert tuple(xyz.view(np.uint32)[0].tolist()) == QUIETED


def test_decoder_stops_at_its_capacity(decode):
    buf = update(vfield(1, 1)) + update(vfield(1, 2))
    assert decode(buf, 1) is None
    ids, _ = decode(buf, 2)
    assert ids.tolist() == [1, 2]


# ---- update_entities against update_entity ------------------------------

CAPACITY = 12


def small_engine() -> SpatialEngine:
    eng = SpatialEngine(GridSpec(-400.0, -400.0, 100.0, 100.0, 8, 8),
                        entity_capacity=CAPACITY, query_capacity=4, sub_capacity=4,
                        device="cpu")
    for i in range(6):
        eng.add_entity(100 + i, -350.0 + 60 * i, 0.0, 10.0 * i)
    eng.remove_entity(103)  # a freed slot, reused by the next new id
    return eng


def host_state(eng: SpatialEngine) -> dict:
    return dict(positions=eng._positions.tobytes(),
                valid=eng._valid.tobytes(),
                slot_of_entity=list(eng._slot_of_entity.items()),
                entity_of_slot=eng._entity_of_slot.tobytes(),
                seed_cells=list(eng._seed_cells.items()),
                free=list(eng._free),
                dirty=set(eng._dirty_slots))


def rows(*updates, snan_row: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """The updates as columns; ``snan_row``'s position, if given, holds the
    signalling NaNs' bits, which no Python float can carry."""
    ids = np.array([u[0] for u in updates], np.uint32)
    xyz = np.array([u[1:] for u in updates], np.float32).reshape(-1, 3)
    if snan_row >= 0:
        xyz.view(np.uint32)[snan_row] = SNAN
    return ids, xyz


NAN = float(np.float32(np.nan))
BATCHES = {
    "known_ids": rows((100, 1.0, 2.0, 3.0), (105, -1.0, 0.0, NAN), (101, np.inf, 0, -np.inf)),
    "id_repeated": rows((100, 1.0, 0, 0), (102, 2.0, 0, 0), (100, 3.0, 0, 0),
                        (102, -0.0, 0, 0), (100, 5.0, 0, 0)),
    "unknown_id_twice": rows((900, 1.0, 0, 0), (101, 2.0, 0, 0), (900, 3.0, 0, 7.0)),
    "freed_slot_reused": rows((103, 1.0, 1.0, 1.0), (901, 2.0, 0, 0), (902, 3.0, 0, 0)),
    "new_ids_fill_every_slot": rows(*[(1000 + i, float(i), 0, 0) for i in range(7)],
                                    (1003, 9.0, 9.0, 9.0)),
    "more_new_ids_than_slots": rows((100, 4.0, 0, 0), *[(2000 + i, float(i), 0, 0)
                                                        for i in range(8)], (101, 5.0, 0, 0),
                                    snan_row=0),
    "hazard_floats": rows((100, 1e20, -1e20, 0), (104, NAN, NAN, NAN), (950, -0.0, 0, np.inf)),
    "signalling_nans": rows((101, 0, 0, 0), (951, 0, 0, 0), (101, 1.0, 0, 0), snan_row=1),
}


@pytest.mark.parametrize("case", sorted(BATCHES))
@pytest.mark.parametrize("removed", [(), (100, 900)], ids=["no_removal", "removed_after"])
def test_update_entities_is_the_per_entity_loop(case, removed):
    """One batch leaves every host table as the per-entity calls do, an
    exhausted capacity included: the same exception at the same update,
    with the same partial state; then a removal of an updated id in the
    same step, and the tick's flush, agree too. Both store the float32
    bits they are given, a signalling NaN's included."""
    ids, xyz = BATCHES[case]
    batch, loop = small_engine(), small_engine()
    errors = []
    for eng, apply in (
        (batch, lambda e: e.update_entities(ids, xyz)),
        (loop, lambda e: [e.update_entity(int(i), *row) for i, row in zip(ids, xyz)]),
    ):
        try:
            apply(eng)
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is not None) == (case == "more_new_ids_than_slots")
    assert host_state(batch) == host_state(loop)
    for eng in (batch, loop):
        for eid in removed:
            eng.remove_entity(eid)
    assert host_state(batch) == host_state(loop)
    for eng in (batch, loop):
        eng.tick(33)
    assert np.array_equal(batch._d_positions.numpy().view(np.uint32),
                          loop._d_positions.numpy().view(np.uint32))
    assert np.array_equal(batch._d_valid.numpy(), loop._d_valid.numpy())


# ---- the whole sidecar ------------------------------------------------------


class Ctx:
    def invocation_metadata(self):
        return ()

    def peer(self) -> str:
        return "ipv4:127.0.0.1:1"

    def abort(self, code, details):
        raise RuntimeError(details)


def servicers(config: ConfigRequest, monkeypatch) -> tuple:
    """(columnar, withheld): two CPU sidecars, the second configured with
    the decoder withheld, as on a host without g++. The first's decoder
    counts the updates it decodes in ``decoded``."""
    columnar = service.SpatialDecisionServicer(device="cpu")
    columnar.install(config)
    withheld = service.SpatialDecisionServicer(device="cpu")
    with monkeypatch.context() as m:
        m.setattr(native, "load_step_columns", lambda: None)
        withheld.install(config)
    assert columnar._step_columns is not None and withheld._step_columns is None
    decode, decoded = columnar._step_columns, [0]

    def counting(buf, cap):
        got = decode(buf, cap)
        decoded[0] += len(got[0])
        return got

    columnar._step_columns = counting
    columnar.decoded = decoded
    return columnar, withheld


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_columnar_sidecar_answers_as_the_per_update_sidecar(decode, monkeypatch, seed):
    """The sidecar that decodes each request's bytes and the one that reads
    each update's fields in Python answer alike and hold the same tables;
    the decoder reads every update."""
    columnar, withheld = servicers(ConfigRequest(**CONFIG), monkeypatch)
    total = 0
    for req in step_requests(seed=seed, steps=12):
        total += len(req.updates)
        assert columnar.step(req, Ctx()) == withheld.step(req, Ctx())
        assert host_state(columnar.engine) == host_state(withheld.engine)
    assert total > 0 and columnar.decoded[0] == total


def test_plain_object_requests_are_read_field_by_field(decode):
    """``decide`` with a request of plain objects (no wire bytes) reads its
    updates' fields in Python and applies them as a protobuf request's."""
    plain = service.SpatialDecisionServicer(device="cpu")
    plain.install(ConfigRequest(**CONFIG))
    proto = service.SpatialDecisionServicer(device="cpu")
    proto.install(ConfigRequest(**CONFIG))
    for step in range(2):
        ups = [SimpleNamespace(entityId=7 + i, x=10.0 * i + step, y=0.0, z=-5.0 * i)
               for i in range(5)]
        req = SimpleNamespace(updates=ups, removedEntityIds=[7] * step, queries=[],
                              removedQueryConnIds=[], addSubscriptions=[], removeSubIds=[],
                              nowMs=40 + 33 * step, fullInterest=False)
        pb = StepRequest(nowMs=req.nowMs, removedEntityIds=req.removedEntityIds)
        for up in ups:
            pb.updates.add(entityId=up.entityId, x=up.x, y=up.y, z=up.z)
        got, want = plain.decide(req), proto.decide(pb)
        assert all(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
                   for a, b in zip(got, want, strict=True))
        assert host_state(plain.engine) == host_state(proto.engine)
    assert plain.engine.entity_count() == 4


BENCH_WORLD = dict(worldOffsetX=-15000, worldOffsetZ=-15000, gridWidth=2000, gridHeight=2000,
                   gridCols=15, gridRows=15, entityCapacity=131072, queryCapacity=64,
                   subCapacity=256)

# One EntityPosition as StepRequest field 1: its tag and length, then the
# entityId as a 3-byte varint (ids in [2**14, 2**21)) and x, y, z as fixed32.
POSITION = np.dtype([("head", "u1", 2), ("id_tag", "u1"), ("id", "u1", 3), ("x_tag", "u1"),
                     ("x", "<u4"), ("y_tag", "u1"), ("y", "<u4"), ("z_tag", "u1"), ("z", "<u4")])


def position_bytes(ids: np.ndarray, bits: np.ndarray) -> bytes:
    """The wire bytes of one update a row, built from the columns."""
    assert ids.min() >= 1 << 14 and ids.max() < 1 << 21
    out = np.empty(len(ids), POSITION)
    out["head"] = (0x0A, POSITION.itemsize - 2)
    out["id_tag"], out["x_tag"], out["y_tag"], out["z_tag"] = 0x08, 0x15, 0x1D, 0x25
    out["id"] = np.stack([ids & 0x7F | 0x80, ids >> 7 & 0x7F | 0x80, ids >> 14], 1)
    out["x"], out["y"], out["z"] = bits.T
    return out.tobytes()


def all_moving_requests(n: int = 100_000, seed: int = 3100000001):
    """Two steps of 100,000 entities, shaped as the benchmark's all_moving
    mix sends them: the first rows pinned to NaN, ±inf, 1e20, cell
    boundaries and a signalling NaN; in step 1, every entity moves, 50
    leave and 50 new ids join. Each request is built once, from arrays."""
    rng = np.random.default_rng(seed)
    lo, world, cell = -15000.0, 30000.0, 2000.0
    ids = np.arange(1, n + 1, dtype=np.int64) + 524288
    pos = rng.uniform(lo, lo + world, (n, 3)).astype(np.float32)
    pos[:, 1] = 0.0
    pos[:6, 0] = [np.nan, np.inf, -np.inf, 1e20, lo, lo + 8 * cell]
    pos[:6, 2] = [0.0, 0.0, 0.0, 0.0, lo + cell, np.nan]
    rest = StepRequest(nowMs=1000, fullInterest=True)
    for conn in range(1, 33):
        c = rng.uniform(lo, lo + world, 2)
        rest.queries.add(connId=conn, kind=AOI_SPHERE, centerX=float(c[0]),
                         centerZ=float(c[1]), extentX=4000.0)
    for sub in range(1, 65):
        rest.addSubscriptions.add(subId=sub, fanOutIntervalMs=33 + sub, firstDueMs=1000 + sub)
    for step in range(2):
        if step:
            pos[6:, 0] = (pos[6:, 0] - lo + rng.uniform(-60, 60, n - 6)) % world + lo
            joining = np.arange(50, dtype=np.int64) + ids[-1] + 1
            ids = np.concatenate([ids, joining])
            pos = np.concatenate([pos, rng.uniform(lo, lo + world, (50, 3)).astype(np.float32)])
            rest = StepRequest(nowMs=1033, removedEntityIds=rng.choice(ids[6:n], 50, replace=False))
        bits = pos.view(np.uint32).copy()
        bits[6] = SNAN
        yield StepRequest.FromString(position_bytes(ids, bits) + rest.SerializeToString())


def test_columnar_sidecar_at_the_benchmark_scale(decode, monkeypatch):
    """Steps of 100,000 updates, hazard rows and churn included: the same
    responses and host tables, every update through the decoder."""
    columnar, withheld = servicers(ConfigRequest(**BENCH_WORLD), monkeypatch)
    total = 0
    for req in all_moving_requests():
        total += len(req.updates)
        assert columnar.step(req, Ctx()) == withheld.step(req, Ctx())
        assert host_state(columnar.engine) == host_state(withheld.engine)
    assert total == 200_050 and columnar.decoded[0] == total
    assert columnar.engine.entity_count() == 100_000
    slot = columnar.engine._slot_of_entity[524288 + 7]
    assert tuple(columnar.engine._positions.view(np.uint32)[slot].tolist()) == QUIETED
