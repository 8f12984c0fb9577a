"""The references and their control: the wire, the overflow path, and the
control (the reference in bfloat16) refused on every seed."""

from __future__ import annotations

import numpy as np
import pytest

import portbench_tiny as tiny
from portbench.core import wire
from portbench.core.harness import benchmark, find_cell
from portbench.gen.sidecar_load import Load
from portbench.reference import control, geometry


def test_a_request_the_benchmark_writes_parses_as_the_program_reads_it():
    from channeld_tpu_torch.ops import service_pb2 as pb

    _, config, mix = find_cell(benchmark(), "sidecar.bench100k.all_moving")
    load = Load(3, config["grid"], {**mix, **tiny.SIDECAR["mix"]})
    for i in range(3):
        st = load.step(i)
        req = pb.StepRequest.FromString(wire.step_request(st))
        assert [u.entityId for u in req.updates] == st.upd_ids.tolist()
        got = np.array([[u.x, u.y, u.z] for u in req.updates], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32), st.upd_pos.view(np.uint32))
        assert list(req.removedEntityIds) == st.removed_entities.tolist()
        assert [q.connId for q in req.queries] == [q.conn for q in st.queries]
        assert [list(q.spotDists) for q in req.queries] == [list(q.spot_dists) for q in st.queries]
        assert list(req.removeSubIds) == st.remove_subs.tolist()
        assert [s.firstDueMs for s in req.addSubscriptions] == st.add_sub_first.tolist()
        assert req.nowMs == st.now_ms and req.fullInterest == st.full


def test_a_response_the_program_writes_reads_back():
    from channeld_tpu_torch.ops import service_pb2 as pb

    resp = pb.StepResponse(engineNowMs=1033, handoverCount=5000)
    resp.handovers.add(entityId=7, srcCell=1, dstCell=2)
    resp.cellCounts.extend([0, 3, 2**31])
    resp.interests.add(connId=9).cells.extend([4, 200])
    resp.interests[0].dists.extend([0, 3])
    resp.dueSubIds.extend([1, 300, 70000])
    d = wire.step_response(resp.SerializeToString())
    assert d.handover_count == 5000 and d.now_ms == 1033
    assert d.handovers.tolist() == [[7, 1, 2]] and d.cell_counts.tolist() == [0, 3, 2**31]
    assert {k: (a.tolist(), b.tolist()) for k, (a, b) in d.interests.items()} == {
        9: ([4, 200], [0, 3])}
    assert d.due_sub_ids.tolist() == [1, 300, 70000]


def test_the_overflow_path_holds():
    """A respawn wave larger than the 4,096 handover rows: crossings beyond
    the rows keep their old cell and come back the next step."""
    size = {"config": tiny.SIDECAR["config"],
            "mix": {**tiny.SIDECAR["mix"], "entities": 4000, "burst_entities": 3990}}
    size["config"] = {**size["config"], "entity_capacity": 8192}
    from portbench.core import harness

    out = harness.run("sidecar.bench100k.all_moving", 9, 0.5, False, device="cpu",
                      overrides=size)
    assert out["correct"]
    from portbench.reference.sidecar_ref import SidecarRef

    _, config, mix = find_cell(benchmark(), "sidecar.bench100k.all_moving")
    mix = {**mix, **size["mix"]}
    ref = SidecarRef(config["grid"], 8192, 128, 1024, 2000)
    load = Load(9, config["grid"], mix)
    counts = [ref.apply(load.step(i)).handover_count for i in range(4)]
    assert counts[2] > 2000  # the wave at step 2 overflows a 2,000-row budget
    assert counts[3] >= counts[2] - 2000  # and what was left over comes back


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.0e38, np.nan, -0.0], np.float32)
    got = geometry.bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == np.float32(1.0078125)
    assert np.isnan(got[4]) and np.signbit(got[5])


@pytest.mark.parametrize("workload", sorted(tiny.SIZES))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_refused(workload, seed):
    got = control.readings(workload, seed, 30, tiny.SIZES[workload])
    assert max(got.values()) > 0, got
