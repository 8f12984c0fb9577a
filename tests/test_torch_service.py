"""channeld_tpu_torch.ops.service against channeld_tpu.ops.service.

Both sidecars run on real sockets (the port's on ``device="cpu"``) and
get the same StepRequests; their StepResponses must be equal. The two
packages' service_pb2 modules are byte-identical copies of one
descriptor, so the responses are messages of the same classes.
"""

import grpc
import numpy as np
import pytest
import torch

from channeld_tpu.ops import service as jax_service
from channeld_tpu_torch.ops import service as port_service
from channeld_tpu_torch.ops.service_pb2 import ConfigRequest, StepRequest

CONFIG = dict(worldOffsetX=-400, worldOffsetZ=-400, gridWidth=100, gridHeight=100,
              gridCols=8, gridRows=8, entityCapacity=64, queryCapacity=8,
              subCapacity=32)


def test_both_packages_share_the_message_classes():
    from channeld_tpu.ops import service_pb2 as a
    from channeld_tpu_torch.ops import service_pb2 as b

    assert a.DESCRIPTOR.serialized_pb == b.DESCRIPTOR.serialized_pb
    assert a.StepRequest(nowMs=3) == b.StepRequest(nowMs=3)


@pytest.fixture
def sidecars():
    """(jax client, port client, port servicer, make_clients) over two
    live servers."""
    servers, clients = [], []
    jax_server, _, jax_port = jax_service.create_server(port=0, auth_token="")
    port_server, port_servicer, port_port = port_service.create_server(
        port=0, auth_token="", device="cpu")
    for s in (jax_server, port_server):
        s.start()
        servers.append(s)

    def make_clients():
        pair = (jax_service.SpatialDecisionClient(f"127.0.0.1:{jax_port}"),
                port_service.SpatialDecisionClient(f"127.0.0.1:{port_port}"))
        clients.extend(pair)
        return pair

    jc, pc = make_clients()
    yield jc, pc, port_servicer, make_clients
    for c in clients:
        c.close()
    for s in servers:
        s.stop(None)


def step_requests(seed, steps):
    rng = np.random.default_rng(seed)
    entities, conns, subs = [], [], []
    next_entity, next_conn, next_sub = 0x80001, 1, 1
    for step in range(steps):
        req = StepRequest(nowMs=10 + 33 * step, fullInterest=(step == 5))
        for _ in range(int(rng.integers(2, 7))):
            if len(entities) < 50:
                entities.append(next_entity)
                next_entity += 1
        for eid in entities:
            if rng.random() < 0.6:
                x, z = rng.uniform(-450, 450, 2)
                if rng.random() < 0.2:
                    x = -400.0 + 100.0 * rng.integers(0, 9)
                if rng.random() < 0.03:
                    x = float(rng.choice([np.nan, np.inf]))
                req.updates.add(entityId=eid, x=x, y=0.0, z=z)
        if step and entities and rng.random() < 0.5:
            req.removedEntityIds.append(entities.pop(int(rng.integers(len(entities)))))
        for _ in range(int(rng.integers(0, 3))):
            if conns and rng.random() < 0.5:
                conn = conns[int(rng.integers(len(conns)))]
            elif len(conns) < 7:
                conn = next_conn
                next_conn += 1
                conns.append(conn)
            else:
                continue
            kind = int(rng.integers(0, 5))
            q = req.queries.add(connId=conn, kind=kind)
            q.centerX, q.centerZ = (float(v) for v in rng.uniform(-450, 450, 2))
            q.extentX, q.extentZ = (float(v) for v in rng.uniform(10, 250, 2))
            if rng.random() < 0.7:
                q.dirX, q.dirZ = (float(v) for v in rng.normal(size=2))
            q.angle = float(rng.uniform(0.1, 1.4))
            if kind == 4:
                k = int(rng.integers(1, 4))
                q.spotX.extend(rng.uniform(-450, 450, k).tolist())
                q.spotZ.extend(rng.uniform(-450, 450, k).tolist())
                q.spotDists.extend(rng.integers(0, 5, int(rng.integers(0, k + 1))).tolist())
        if conns and rng.random() < 0.2:
            req.removedQueryConnIds.append(conns.pop(int(rng.integers(len(conns)))))
        for _ in range(int(rng.integers(0, 3))):
            if len(subs) < 28:
                req.addSubscriptions.add(subId=next_sub,
                                         fanOutIntervalMs=int(rng.integers(20, 120)),
                                         firstDueMs=int(10 + 33 * step + rng.integers(0, 60)))
                subs.append(next_sub)
                next_sub += 1
        if subs and rng.random() < 0.3:
            req.removeSubIds.append(subs.pop(int(rng.integers(len(subs)))))
        yield req


def test_sidecars_answer_the_same_unary_steps(sidecars):
    """Two gateway clients per sidecar, alternating: per-caller delta
    interest, the first-contact full sync, fullInterest, handovers,
    spots, removals and due ids all agree response by response."""
    jc, pc, _, make_clients = sidecars
    jc.configure(**CONFIG)
    pc.configure(**CONFIG)
    jc2, pc2 = make_clients()
    handovers = interests = due = 0
    for i, req in enumerate(step_requests(seed=3, steps=14)):
        a, b = (jc, pc) if i % 3 else (jc2, pc2)
        ra, rb = a.step(req), b.step(req)
        assert ra == rb, f"step {i}"
        handovers += len(rb.handovers)
        interests += len(rb.interests)
        due += len(rb.dueSubIds)
    assert handovers and interests and due


def test_sidecars_answer_the_same_streams_with_in_band_errors(sidecars):
    jc, pc, _, _ = sidecars
    jc.configure(**CONFIG)
    pc.configure(**CONFIG)

    def requests():
        for i, req in enumerate(step_requests(seed=4, steps=6)):
            if i == 2:
                bad = StepRequest(nowMs=req.nowMs)
                q = bad.queries.add(connId=9, kind=4)
                q.spotX.extend([1.0, 2.0])
                q.spotZ.extend([1.0])  # mismatched -> in-band error
                yield bad
            yield req

    ra = list(jc.step_stream(requests()))
    rb = list(pc.step_stream(requests()))
    assert ra == rb and len(rb) == 7
    assert "mismatch" in rb[2].error
    assert all(r.error == "" for i, r in enumerate(rb) if i != 2)


def test_unary_validation_error_is_invalid_argument(sidecars):
    _, pc, _, _ = sidecars
    pc.configure(**CONFIG)
    bad = StepRequest(nowMs=5)
    q = bad.queries.add(connId=9, kind=4)
    q.spotX.extend([1.0])
    with pytest.raises(grpc.RpcError) as e:
        pc.step(bad)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


@pytest.mark.parametrize("mesh_devices", [0, 1, 8])
def test_sidecars_answer_the_same_meshed_steps(sidecars, mesh_devices):
    """Ports test_service.py::test_sidecar_step_roundtrip's mesh cases:
    Configure(meshDevices=N) shards both engines (the JAX one over N
    virtual devices, the port's over N shards on the CPU; N = 1 is a mesh
    of one in both) and every response is equal."""
    jc, pc, servicer, _ = sidecars
    jc.configure(meshDevices=mesh_devices, **CONFIG)
    pc.configure(meshDevices=mesh_devices, **CONFIG)
    mesh = servicer.engine._mesh
    assert (mesh.size if mesh is not None else 0) == mesh_devices
    for i, req in enumerate(step_requests(seed=7, steps=8)):
        ra, rb = jc.step(req), pc.step(req)
        assert ra == rb, f"step {i}"


def test_mesh_wider_than_the_devices_present_is_invalid_argument(sidecars, monkeypatch):
    """As the JAX sidecar answers a mesh wider than its devices: the JAX
    one asked for 16 of its 8 virtual devices, the port's (on ``cuda``)
    for 2 cards where one is present; both INVALID_ARGUMENT, and no
    engine is installed."""
    jc, _, _, _ = sidecars
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    server, servicer, port = port_service.create_server(port=0, auth_token="", device="cuda")
    server.start()
    client = port_service.SpatialDecisionClient(f"127.0.0.1:{port}")
    try:
        codes = []
        for c, n in ((jc, 16), (client, 2)):
            with pytest.raises(grpc.RpcError) as e:
                c.configure(meshDevices=n, **CONFIG)
            codes.append(e.value.code())
        assert codes == [grpc.StatusCode.INVALID_ARGUMENT] * 2
        assert servicer.engine is None
    finally:
        client.close()
        server.stop(None)


def test_step_before_configure_fails_precondition(sidecars):
    _, pc, _, _ = sidecars
    with pytest.raises(grpc.RpcError) as e:
        pc.step(StepRequest(nowMs=1))
    assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION


def test_shared_secret_auth():
    server, _, port = port_service.create_server(port=0, auth_token="sesame",
                                                 device="cpu")
    server.start()
    try:
        bad = port_service.SpatialDecisionClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as e:
            bad.configure(**CONFIG)
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED
        bad.close()
        good = port_service.SpatialDecisionClient(f"127.0.0.1:{port}",
                                                  auth_token="sesame")
        good.configure(**CONFIG)
        assert good.step(StepRequest(nowMs=5)).engineNowMs == 5
        good.close()
    finally:
        server.stop(None)


def test_client_retries_transient_failures_then_raises():
    client = port_service.SpatialDecisionClient(
        "127.0.0.1:1", timeout_s=0.5, max_retries=2, backoff_s=0.01)
    with pytest.raises(grpc.RpcError) as e:
        client.configure(gridCols=1, gridRows=1, gridWidth=1.0, gridHeight=1.0)
    assert e.value.code() == grpc.StatusCode.UNAVAILABLE
    client.close()


def test_in_process_decide_matches_the_wire(sidecars):
    """``install``/``decide`` (the pass without gRPC) give the decisions
    the wire carries."""
    _, pc, _, _ = sidecars
    pc.configure(**CONFIG)
    local = port_service.SpatialDecisionServicer(device="cpu")
    local.install(ConfigRequest(**CONFIG))
    for req in step_requests(seed=5, steps=5):
        wire = pc.step(req)
        d = local.decide(req)
        assert d.handover_count == wire.handoverCount
        assert [(h.entityId, h.srcCell, h.dstCell) for h in wire.handovers] == d.handovers
        assert list(wire.cellCounts) == d.cell_counts.tolist()
        assert [(ir.connId, list(ir.cells), list(ir.dists)) for ir in wire.interests] == [
            (c, cells.tolist(), dists.tolist()) for c, cells, dists in d.interests]
        assert list(wire.dueSubIds) == d.due_sub_ids
