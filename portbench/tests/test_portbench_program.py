"""The metrics that read the program's own spans (``core/program.py``): a
traced tiny run of each cell on the CPU reports its cell's, an untraced one
none; with no program span to read (a tree older than the spans), each
reports nothing and raises nothing."""

from __future__ import annotations

import pytest

import portbench_tiny as tiny
from portbench.core import harness
from portbench.core.spans import Event

NEW = {"sidecar_ingest_ms", "ingest_ns_per_update", "sidecar_reply_ms", "engine_flush_ms",
       "flush_bytes_per_step", "engine_readback_ms"}
CELL_NEW = {"sidecar.bench100k.all_moving": NEW,
            "crowd.sim100k": {"engine_flush_ms", "flush_bytes_per_step", "engine_readback_ms"}}


@pytest.fixture(autouse=True)
def fresh_recorder():
    from channeld_tpu_torch.core import tracing

    tracing.reset_tracing()
    yield
    tracing.reset_tracing()


@pytest.mark.parametrize("workload", sorted(tiny.SIZES))
def test_a_traced_run_reports_its_cells_program_metrics(workload):
    out = tiny.run(workload, seed=2**31 + 11, trace=True)
    assert out["correct"] is True
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW}
    assert set(got) == CELL_NEW[workload]
    assert all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("workload", sorted(tiny.SIZES))
def test_an_untraced_run_reports_none_of_them(workload):
    out = tiny.run(workload, seed=2**31 + 12, trace=False)
    assert not set(out["metrics"]) & NEW


def test_with_no_program_span_each_reports_nothing():
    rec = dict(steps_a=[dict(lat_ms=1.0, events=[Event("sidecar.step", "", 1.0, 2.0)])])
    for name in sorted(NEW):
        assert harness.load_metric(name).read(rec) is None
        assert harness.load_metric(name).read({}) is None
