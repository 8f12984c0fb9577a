"""The port's flight recorder inside the sidecar's decision pass and the
engine's tick (``channeld_tpu_torch/core/tracing.py``, ``ops/service.py``,
``ops/engine.py``), and the benchmark's reading of it
(``portbench/core/program.py``).

The sidecar's unary Step records ``sidecar.step`` around ``sidecar.ingest``
(counting the updates and removals), ``sidecar.edits``, the engine's spans,
``sidecar.interest``, ``sidecar.due`` and ``sidecar.respond``; the engine's
tick records ``engine.tick`` around ``engine.flush`` (counting the bytes it
uploads) and its device calls, and the host's reads ``engine.read.*``. With
the recorder off nothing is recorded and the decisions are the same. Counts
reach dumps as ``args.count`` under the pinned Perfetto schema; ``since``
reads only what is new; every call site stamps with ``recorder.now()``; the
benchmark converts the recorder's stamps to ``time.perf_counter`` and hands
each step its spans.
"""

from __future__ import annotations

import ast
import os
import sys
import time

import numpy as np
import pytest

from channeld_tpu_torch.core import tracing
from channeld_tpu_torch.ops import service
from channeld_tpu_torch.ops.engine import SpatialEngine
from channeld_tpu_torch.ops.service_pb2 import ConfigRequest, StepRequest
from channeld_tpu_torch.ops.spatial_ops import AOI_SPHERE, GridSpec
from portbench.core import harness, program
from portbench.core.spans import Event
from test_torch_elastic import REPO, chip_smoke
from test_torch_service import CONFIG, step_requests

recorder = tracing.recorder
SIDECAR_CHILDREN = ("sidecar.ingest", "sidecar.edits", "engine.tick", "sidecar.interest",
                    "sidecar.due", "sidecar.respond")
ENGINE_CHILDREN = ("engine.flush", "engine.spatial_step")


@pytest.fixture(autouse=True)
def fresh_recorder(tmp_path):
    recorder.configure(dump_path=str(tmp_path))
    yield
    tracing.reset_tracing()


class Ctx:
    def invocation_metadata(self):
        return ()

    def peer(self) -> str:
        return "ipv4:127.0.0.1:1"

    def abort(self, code, details):
        raise RuntimeError(details)


def servicer() -> service.SpatialDecisionServicer:
    svc = service.SpatialDecisionServicer(device="cpu")
    svc.install(ConfigRequest(**CONFIG))
    return svc


def stepped(svc, requests: list) -> list[list[dict]]:
    """The recorder's spans of each unary step of ``requests``."""
    out = []
    for req in requests:
        mark = recorder.mark()
        svc.step(req, Ctx())
        out.append(recorder.since(mark)[0])
    return out


def inside(child: dict, parent: dict) -> bool:
    return (parent["start_ns"] <= child["start_ns"]
            and child["start_ns"] + child["dur_ns"] <= parent["start_ns"] + parent["dur_ns"])


def one(spans: list, name: str) -> dict:
    got = [s for s in spans if s["name"] == name]
    assert len(got) == 1, (name, [s["name"] for s in spans])
    return got[0]


@pytest.mark.parametrize("step", range(4))
def test_a_step_records_the_sidecars_span_tree(step):
    """Each step: one ``sidecar.step`` holding its stages in their order,
    the engine's flush and spatial step inside its tick, the interest rows'
    read inside ``sidecar.interest``."""
    spans = stepped(servicer(), list(step_requests(seed=3, steps=4)))[step]
    top = one(spans, "sidecar.step")
    children = [one(spans, name) for name in SIDECAR_CHILDREN]
    assert all(inside(c, top) for c in children)
    ends = [(c["start_ns"], c["start_ns"] + c["dur_ns"]) for c in children]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])), "stages overlap or reorder"
    tick = one(spans, "engine.tick")
    assert all(inside(one(spans, name), tick) for name in ENGINE_CHILDREN)
    for name in ("engine.read.consume", "engine.handover_list"):
        read = one(spans, name)
        assert inside(read, top) and read["start_ns"] >= tick["start_ns"] + tick["dur_ns"]
    interest = one(spans, "sidecar.interest")
    for s in spans:
        if s["name"] == "engine.read.interest_rows":
            assert inside(s, interest)


@pytest.mark.parametrize("seed", [1, 2])
def test_ingest_counts_the_requests_updates_and_removals(seed):
    requests = list(step_requests(seed=seed, steps=6))
    for req, spans in zip(requests, stepped(servicer(), requests)):
        ingest = one(spans, "sidecar.ingest")
        assert ingest["count"] == len(req.updates) + len(req.removedEntityIds)
        assert all("count" not in s for s in spans
                   if s["name"] not in ("sidecar.ingest", "engine.flush"))


def engine() -> SpatialEngine:
    eng = SpatialEngine(GridSpec(-400.0, -400.0, 100.0, 100.0, 8, 8), entity_capacity=64,
                        query_capacity=8, sub_capacity=16, device="cpu")
    eng.add_subscription(50)
    eng.set_query(1, AOI_SPHERE, (0.0, 0.0), (150.0, 0.0))
    for i in range(20):
        eng.add_entity(100 + i, -350.0 + 30 * i, 0.0, 10.0)
    eng.tick(0)
    return eng


def flush_count(eng, now_ms: int) -> int:
    mark = recorder.mark()
    eng.tick(now_ms)
    return one(recorder.since(mark)[0], "engine.flush")["count"]


@pytest.mark.parametrize("k", [0, 1, 7, 20])
def test_flush_counts_the_bytes_it_uploads(k):
    """0 bytes on a tick with nothing dirty; at least k * (12 + 1) (a
    position row and its valid flag) after k position updates."""
    eng = engine()
    assert flush_count(eng, 33) == 0
    for i in range(k):
        eng.update_entity(100 + i, 5.0 * i, 0.0, -5.0 * i)
    got = flush_count(eng, 66)
    assert got >= k * (12 + 1) and (got > 0) == (k > 0)
    assert flush_count(eng, 99) == 0


def test_the_engines_reads_and_host_work_record_once_each():
    """``consume`` reads the blob once however often it is asked;
    ``query_changed_rows``, ``interest_rows``, ``handover_list`` and
    ``absorb_census`` each record their span."""
    eng = engine()
    eng.track_query_changes = True
    mark = recorder.mark()
    out = eng.tick(33)
    eng.consume(out)
    eng.consume(out)
    eng.handover_list(out)
    eng.interest_rows(out, [0])
    eng.query_changed_rows(out)
    eng.query_changed_rows(out)
    slots = np.arange(4)
    cols = (eng._positions.copy(), np.zeros((64, 3), np.float32), np.zeros(64, np.int32),
            np.zeros((64, 3), np.float32))
    eng._vel, eng._sim_state, eng._sim_target = cols[1].copy(), cols[2].copy(), cols[3].copy()
    eng.absorb_census(slots, *cols)
    names = [s["name"] for s in recorder.since(mark)[0]]
    for name in ("engine.tick", "engine.flush", "engine.spatial_step", "engine.query_diff",
                 "engine.read.consume", "engine.handover_list", "engine.read.interest_rows",
                 "engine.read.changed_rows", "engine.absorb_census"):
        assert names.count(name) == 1, (name, names)


def decisions(svc, requests, on: bool) -> list:
    recorder.enabled = on
    return [svc.decide(req) for req in requests]


def test_recorder_off_records_nothing_and_decides_the_same():
    requests = list(step_requests(seed=9, steps=6))
    want = decisions(servicer(), requests, True)
    svc = servicer()
    recorder.reset()
    got = decisions(svc, requests, False)
    svc.step(StepRequest(nowMs=999), Ctx())
    assert recorder.stats()["spans"] == 0 and recorder.snapshot() == []
    for a, b in zip(want, got):
        assert (a.now_ms, a.handover_count, a.handovers, a.due_sub_ids) == \
            (b.now_ms, b.handover_count, b.handovers, b.due_sub_ids)
        assert np.array_equal(a.cell_counts, b.cell_counts)
        assert [(c, x.tolist(), d.tolist()) for c, x, d in a.interests] == \
            [(c, x.tolist(), d.tolist()) for c, x, d in b.interests]


def test_a_count_reaches_the_dump_under_the_pinned_schema(tmp_path):
    t0 = recorder.now()
    recorder.span("sidecar.ingest", t0, count=1234)
    recorder.stage("device_step", t0)
    recorder.instant("mark")
    path = recorder.dump_trace(path=str(tmp_path / "d.json"))
    ok, note, names = chip_smoke().check_perfetto(path)
    assert ok, note
    assert {"sidecar.ingest", "device_step", "mark"} <= names
    import json

    events = {e["name"]: e for e in json.load(open(path))["traceEvents"]}
    assert events["sidecar.ingest"]["args"]["count"] == 1234
    assert events["sidecar.ingest"]["ph"] == "X" and events["mark"]["ph"] == "i"
    assert "count" not in events["device_step"]["args"]
    assert [s["count"] for s in recorder.snapshot() if "count" in s] == [1234]


@pytest.mark.parametrize("ring", [16, 40])
def test_since_reads_only_newer_spans_and_changes_no_dump(tmp_path, ring):
    recorder.configure(ring_spans=ring, dump_path=str(tmp_path))
    for i in range(10):
        recorder.span(f"old.{i}", recorder.now())
    mark = recorder.mark()
    for i in range(25):
        recorder.span(f"new.{i}", recorder.now(), count=i)
    before = recorder.to_trace_events(recorder.snapshot())
    got, lost = recorder.since(mark)
    assert recorder.to_trace_events(recorder.snapshot()) == before
    kept = min(25, ring)
    assert [s["name"] for s in got] == [f"new.{i}" for i in range(25 - kept, 25)]
    assert lost == 25 - kept
    assert recorder.stats()["dropped"] == max(0, 35 - ring)
    assert recorder.stats()["spans"] == min(35, ring)
    assert recorder.since(recorder.mark()) == ([], 0)


def test_recorder_and_perf_counter_read_one_clock():
    """Stated in core/tracing.py: the recorder's clock is the one
    ``time.perf_counter`` reads (CLOCK_MONOTONIC on Linux)."""
    mono, perf = time.get_clock_info("monotonic"), time.get_clock_info("perf_counter")
    assert mono.implementation == perf.implementation and mono.monotonic
    assert abs(program.clock_offset()) < 1e-3


def test_a_span_converts_between_the_perf_counter_readings_around_it():
    a = time.perf_counter()
    t0 = recorder.now()
    sum(range(20000))
    recorder.span("work", t0, count=3)
    b = time.perf_counter()
    (span,) = program.events(recorder.snapshot(), program.clock_offset())
    assert a <= span.t0 < span.t1 <= b and span.count == 3


def test_each_step_gets_the_program_spans_inside_it():
    """A span belongs to the step whose benchmark events hold its midpoint;
    steps before ``since`` (a ring that overwrote) are left out."""
    steps_a = [dict(events=[Event("sidecar.step", "", 10.0 * i, 10.0 * i + 5.0)])
               for i in range(4)]
    spans = [program.ProgramSpan(n, t, t + 1.0, c) for n, t, c in (
        ("a", 1.0, 7), ("b", 3.9, None), ("a", 11.0, 2), ("a", 21.0, None), ("c", 26.0, None),
        ("a", 31.0, 5), ("b", 35.5, None))]
    got = program.steps(steps_a, spans)
    assert [[e.name for e in s] for s in got] == [["a", "b"], ["a"], ["a"], ["a"]]
    assert [len(s) for s in program.steps(steps_a, spans, since=15.0)] == [1, 1]


def test_idle_gaps_name_the_innermost_program_span():
    """With the program's spans beside the benchmark's, the device's idle
    gaps belong to the innermost span: a program stage inside a wrapper."""
    t0 = recorder.now()
    time.sleep(0.002)
    t1 = recorder.now()
    time.sleep(0.004)
    t2 = recorder.now()
    recorder.span("sidecar.ingest", t0, end_ns=t1)
    recorder.span("sidecar.step", t0, end_ns=t2)
    off = program.clock_offset()
    a, b = t0 / 1e9 + off, t2 / 1e9 + off
    wrapper = [Event("sidecar.decide", "", a - 0.001, b + 0.001)]
    owners = dict(harness._gap_owners([(a, b)], program.with_program(wrapper, a, b)))
    assert owners.pop("sidecar.decide", 0.0) < 1e-6  # the pairing's error at most
    assert set(owners) == {"sidecar.ingest", "sidecar.step"}
    assert owners["sidecar.ingest"] == pytest.approx((t1 - t0) / 1e9, abs=1e-6)
    assert dict(harness._gap_owners([(a, b)], wrapper)) == {"sidecar.decide": pytest.approx(b - a)}


def test_every_recorder_call_site_stamps_with_recorder_now():
    """No span or stage of the port takes a start or end stamp scaled from
    a float clock (``int(t * 1e9)``)."""
    bad = []
    root = os.path.join(REPO, "channeld_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("span", "stage")
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in ("_trace", "recorder")):
                    for arg in list(node.args[1:]) + [k.value for k in node.keywords]:
                        if any(isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult)
                               for n in ast.walk(arg)):
                            bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    assert not bad, bad


def test_the_sidecars_main_arms_the_operator_exits(monkeypatch):
    """``main`` binds SIGUSR2 to a dump and dumps at exit, as the gateway
    does, before it serves."""
    armed = []
    monkeypatch.setattr(tracing, "install_trace_dump_signal", lambda: armed.append("sigusr2"))
    monkeypatch.setattr(tracing, "register_shutdown_dump", lambda: armed.append("exit"))

    def stop(*args, **kwargs):
        armed.append("serve")
        raise SystemExit(0)

    monkeypatch.setattr(service, "create_server", stop)
    monkeypatch.setattr(sys, "argv", ["sidecar", "--device", "cpu"])
    with pytest.raises(SystemExit):
        service.main()
    assert armed == ["sigusr2", "exit", "serve"]
