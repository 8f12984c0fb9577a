"""The trace and obs planes through the port's GPU controller, held against
the JAX package.

``chip_smoke.py``'s phase 13 keeps the port's copies of scripts/trace_soak.py's
and scripts/obs_soak.py's phases 1 and 3 (the test loads chip_smoke.py by
path), written against one package's modules (``gateway_modules(pkg)``):

- the lockstep world (``TraceWorld``, 13a): the trace soak's cells world
  (config/spatial_tpu_cells_2x2.json at 8 shards: the JAX package's 8
  virtual devices, the port's 8 CPU shards) at the soak's tables (256 slots,
  32 query rows), 60 entities, 6 clients' forwards, 2 followers on the
  legacy follower path, a storm of 20, the guard off and the recorder on,
  40 ticks of a fixed clock under the soak's chaos (both points fire).
  Every tick's handovers, tables, outbound streams (the followers' interest
  diffs too), the recorder's span names, the stage counts,
  ``follower_readbacks_total``, the anomalies and the chaos fires are equal
  exactly;
- the live trace phase and the trace overhead phase (13b, 13c) through the
  port on ``cpu`` at ``tests/test_tracing.py::test_trace_soak_smoke``'s
  sizes, with its assertions;
- the live obs phase and the obs overhead phase (13d, 13e) through the port
  on ``cpu`` at ``tests/test_slo.py::test_obs_soak_smoke``'s sizes and smoke
  scenario, with its assertions and the /readyz codes;
- /readyz of a guard set FAILED directly (not terminal) and of a wedged
  WAL, over HTTP, on both packages;
- the port's copies of the soaks' scenarios and parameters equal the
  soaks' own.

One ``cuda`` case runs 13a and the overhead phases small on the card.
"""

from __future__ import annotations

import asyncio
import os
import sys

import pytest
import torch

from test_torch_elastic import REPO, chip_smoke
from test_torch_gateway import JAX, PORT, fresh_runtime, port_globals

PKGS = (JAX, PORT)
CPU = torch.device("cpu")
# Host timings and the port's own transfer counts and engine spans: not part
# of what both compute (the engine spans are held on their own below).
UNCOMPARED = ("tick_ms", "step_ms", "reads", "transfers", "port_spans")
LOCKSTEP = dict(ticks=40, entities=60, followers=2, clients=6, storm=20)
TRACE_SMOKE = dict(live_s=6.0, clients=6, msg_rate=25, entities=60, followers=2, storm_size=20,
                   quiesce_s=2.0, overhead_ticks=40, overhead_rounds=2)
OBS_SMOKE = dict(steady_s=5.0, breach_s=6.0, clients=4, msg_rate=20, viewers=2, update_rate=60.0,
                 entities=40, quiesce_s=1.5, overhead_ticks=30, overhead_rounds=2,
                 scenario={"name": "obs-smoke", "seed": 7, "faults": [
                     {"point": "channel.tick_budget", "every_n": 10, "stall_ms": 60,
                      "max_fires": 40}]})
READYZ_CODES = [200, 503, 200, 200, 503, 200]


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield
        for pkg in PKGS:
            if f"{pkg}.chaos" in sys.modules:
                sys.modules[f"{pkg}.chaos"].disarm()


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """13a's world through both packages once: {pkg: (observations, report)}."""
    cs = chip_smoke()
    tmp = str(tmp_path_factory.mktemp("trace-lockstep"))
    scn = cs.trace_lockstep_scenario(**LOCKSTEP, tables=cs.SOAK_TABLES)
    config = cs.cells_config(8, tmp)
    return {pkg: cs.run_trace_lockstep(cs.gateway_modules(pkg), CPU, scn, config, tmp)
            for pkg in PKGS}


def compared(obs: dict) -> dict:
    return {k: v for k, v in obs.items() if k not in UNCOMPARED}


def test_trace_lockstep_equals_jax_tick_for_tick(lockstep):
    """Every tick of 13a's world equal: handovers, tables, every outbound
    stream, the span names the recorder holds for the tick, the stage
    counts, follower_readbacks_total, the anomalies and the chaos fires."""
    cs = chip_smoke()
    (want, _), (got, _) = lockstep[JAX], lockstep[PORT]
    assert len(got) == len(want) == LOCKSTEP["ticks"]
    for t, (w, g) in enumerate(zip(want, got)):
        where = cs.first_gateway_diff(compared(w), compared(g))
        assert where is None, f"tick {t}: {where}"
    assert sum(len(o["handovers"]) for o in got) > 0
    # The followers (connections 1000 and 1001) got their interest diffs.
    assert all(got[-1]["sent"][1000 + i][0] > 0 for i in range(LOCKSTEP["followers"]))


def test_trace_lockstep_chaos_fires_and_blows_the_same_ticks(lockstep):
    """Both chaos points fire at least 3 times, on the same ticks in both
    packages, and the stalls blow the same ticks' budgets."""
    (want, wr), (got, gr) = lockstep[JAX], lockstep[PORT]
    assert wr["fires"] == gr["fires"] and min(gr["fires"].values()) >= 3, gr["fires"]
    assert [o["fires"] for o in got] == [o["fires"] for o in want]
    anomalies = [a for o in got for a in o["anomalies"]]
    assert anomalies == [a for o in want for a in o["anomalies"]]
    assert {a[0] for a in anomalies} == {"tick_budget"}
    assert any(a[1].startswith("GLOBAL") for a in anomalies)


def test_trace_lockstep_dumps_are_perfetto_valid_with_the_device_step(lockstep):
    """Each package writes at least one tick_budget dump, every dump passes
    the soak's Perfetto schema and holds device_step spans."""
    for pkg in PKGS:
        dumps = lockstep[pkg][1]["dump_checks"]
        assert [d for d in dumps if d[0] == "tick_budget"], pkg
        for trigger, path, ok, note, names in dumps:
            assert ok and "device_step" in names, (pkg, path, note)


def test_trace_lockstep_port_reads_and_stages(lockstep):
    """The port's legacy follower path: two engine transfers a tick (the
    consume blob and one interest_rows for the followers), one
    follower_readbacks_total a tick, every stage of the GLOBAL tick
    measured (ingest needs sockets: 13b), and the port-only engine spans
    exactly: one engine.tick, flush, spatial step, consume read, interest
    rows read and handover list a tick (tick 0 also the warm-up tick's),
    none in the JAX leg."""
    cs = chip_smoke()
    got, _ = lockstep[PORT]
    assert {o["transfers"] for o in got} == {2}
    assert cs.trace_port_spans_wrong(got) == []
    assert all(o["port_spans"] == {} for o in lockstep[JAX][0])
    assert {o["readbacks"] for o in got} == {1}
    stages: dict = {}
    for o in got:
        for k, v in o["stages"].items():
            stages[k] = stages.get(k, 0) + v
    assert all(stages.get(s) for s in cs.TRACE_STAGES if s != "ingest"), stages
    assert stages["device_step"] == stages["readback"] == LOCKSTEP["ticks"]


def test_port_trace_live_and_overhead_phases_smoke(tmp_path):
    """13b and 13c through the port on the CPU at test_trace_soak_smoke's
    sizes, with its assertions."""
    cs = chip_smoke()
    P = cs.gateway_modules(PORT)
    p = cs.trace_params(**TRACE_SMOKE)
    live = asyncio.run(cs.trace_live(P, CPU, p, str(tmp_path), 1, cs.SOAK_TABLES))
    for stage in ("ingest", "messages", "device_step", "readback", "follow_interests",
                  "overload"):
        assert stage in live["stages"], (stage, sorted(live["stages"]))
        assert live["stages"][stage]["count"] > 0
    assert live["follower_readbacks_total"] > 0
    dumped = [d for d in live["anomaly_dumps"] if d["trigger"] == "tick_budget"]
    assert dumped and all(d["perfetto_valid"] for d in dumped)
    assert live["engine_ticks"] > 0 and live["frames_sent"] > 0
    overhead = cs.trace_overhead(P, CPU, cs.OVERHEAD_TABLES, p["overhead_ticks"],
                                 p["overhead_rounds"], str(tmp_path))
    assert overhead["tick_ns_disabled"] > 0
    assert overhead["span_cost_ns"] > 0


def test_port_obs_live_and_overhead_phases_smoke(tmp_path):
    """13d and 13e through the port on the CPU at test_obs_soak_smoke's sizes
    and smoke scenario, with its assertions; the /readyz codes, a FAILED
    that is not terminal, and the guard ACTIVE at the end."""
    cs = chip_smoke()
    P = cs.gateway_modules(PORT)
    p = cs.obs_params(**OBS_SMOKE)
    live = asyncio.run(cs.obs_live(P, CPU, p, str(tmp_path), 1, cs.SOAK_TABLES))
    assert live["healthz_ok"] and live["metrics_ok"]
    assert live["readyz_flip_ok"], live["readyz"]
    assert live["readyz"] == READYZ_CODES
    assert "terminally" not in live["readyz_failed"]["failed_device"]["detail"]
    steady_host = {k: v for k, v in live["steady"].items() if k.endswith("/host")}
    assert steady_host, live["steady"]
    assert sum(live["breaches"].values()) > 0, live
    assert live["breach_ledger_matches_metric"]
    assert live["breach_dumps"] and all(d["perfetto_valid"] for d in live["breach_dumps"])
    assert live["guard_state"] == "ACTIVE" and live["device_state"] == 0
    assert live["engine_ticks"] > 0
    overhead = cs.obs_overhead(P, CPU, cs.OVERHEAD_TABLES, p["overhead_ticks"],
                               p["overhead_rounds"], str(tmp_path))
    assert overhead["tick_ns_disabled"] > 0


def readyz(pkg: str, tmp_path) -> dict:
    """``readyz_flips`` against one package's ops surface on loopback, with
    the guard enabled and the channel plane up (no spatial controller)."""
    cs = chip_smoke()
    P = cs.gateway_modules(pkg)
    cs.reset_gateway(P)
    P.settings.global_settings.device_guard_enabled = True
    P.channel.init_channels()
    ops = P.opshttp.serve_ops(0, host="127.0.0.1")
    try:
        return cs.readyz_flips(P, ops.port, str(tmp_path / pkg))
    finally:
        P.opshttp.reset_ops()
        cs.reset_gateway(P)


@pytest.mark.parametrize("pkg", PKGS)
def test_readyz_flips_across_a_failed_guard_and_a_wedged_wal(pkg, tmp_path):
    """200 -> 503 -> 200 across a FAILED set directly, then across a WAL
    wedge; the FAILED is not terminal and /readyz does not say it is."""
    r = readyz(pkg, tmp_path)
    assert r["codes"] == READYZ_CODES and r["flip_ok"]
    assert not r["failed_terminal"]
    assert r["failed_device"] == {"ok": False, "detail": "device engine FAILED (rebuild retrying)"}


def test_readyz_of_the_port_equals_jax(tmp_path):
    """The same codes and the same device and WAL components in both packages."""
    want, got = readyz(JAX, tmp_path), readyz(PORT, tmp_path)
    assert got["codes"] == want["codes"]
    assert got["failed_device"] == want["failed_device"]
    assert got["wedged_wal"] == want["wedged_wal"]


class Transport:
    """An in-memory byte sink for a real connection (tests/helpers.py's
    FakeTransport)."""

    def __init__(self):
        self.written: list = []
        self.closed = False

    def write(self, data: bytes) -> None:
        self.written.append(data)

    def close(self) -> None:
        self.closed = True

    def remote_addr(self):
        return ("127.0.0.1", 9999)


def ingest_observations(pkg: str, native: bool) -> int:
    """Forwards read by a real client connection and ticked through GLOBAL
    (owned by a real server connection), with the package's native codec
    or without it: the ``ingest`` stage's observations."""
    cs = chip_smoke()
    P = cs.gateway_modules(pkg)
    fresh_runtime(pkg)
    P.settings.global_settings.development = True
    codec = P.connection._native_codec
    if native and codec is None:
        pytest.skip("native codec not built")
    P.connection._native_codec = codec if native else None
    try:
        CT, MT = P.types.ConnectionType, P.types.MessageType
        gch = P.channel.get_global_channel()
        conns = []
        for kind, pit in ((CT.SERVER, "owner"), (CT.CLIENT, "client")):
            conn = P.connection.add_connection(Transport(), kind)
            conn.on_bytes(cs.soak_frame(P, MT.AUTH, P.control_pb2.AuthMessage(
                playerIdentifierToken=pit).SerializeToString()))
            gch.tick_once(0)
            conns.append(conn)
        gch.set_owner(conns[0])
        before = cs.stage_counts(P).get("ingest", 0)
        for i in range(3):
            conns[1].on_bytes(cs.soak_frame(P, 100, bytes([i])))
            gch.tick_once(0)
        return cs.stage_counts(P).get("ingest", 0) - before
    finally:
        P.connection._native_codec = codec


@pytest.mark.parametrize("pkg", PKGS)
def test_the_ingest_stage_needs_the_native_codec(pkg):
    """ROADMAP F19: only the native codec's batched ingest path records the
    ``ingest`` stage; the pure-Python framing (the card's machine has no
    libsnappy.so.1) records none, in both packages."""
    assert ingest_observations(pkg, native=True) == 3
    assert ingest_observations(pkg, native=False) == 0


def soak_module(name: str):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import importlib

    return importlib.import_module(name)


def test_port_copies_of_the_soaks_parameters_equal_the_soaks():
    """chip_smoke.py's copies: each soak's scenario and its phase-1 and
    phase-3 parameters (the federation ones apart); 13a scales only the
    chaos rules' every_n."""
    cs = chip_smoke()
    ts, obs = soak_module("trace_soak"), soak_module("obs_soak")
    assert cs.trace_scenario() == ts.DEFAULT_SCENARIO
    assert cs.obs_scenario() == obs.DEFAULT_SCENARIO
    assert cs.TRACE_STAGES == ts.TRACE_STAGES
    for mine, theirs in ((cs.trace_params(), ts.TraceSoakParams()),
                         (cs.obs_params(), obs.ObsSoakParams())):
        for key, value in mine.items():
            assert getattr(theirs, key) == value, key
    scn = cs.trace_lockstep_scenario()
    rules = {r["point"]: r for r in scn["chaos"]["faults"]}
    assert (rules["channel.tick_budget"]["every_n"], rules["device.dispatch_stall"]["every_n"]) \
        == (300, 37)
    assert [dict(r, every_n=0) for r in scn["chaos"]["faults"]] == [
        dict(r, every_n=0) for r in ts.DEFAULT_SCENARIO["faults"]]
    assert (scn["storm_at"], scn["disperse_at"]) == (45, 105)


@pytest.mark.cuda
def test_trace_lockstep_and_overheads_on_the_card():
    """13a small on the card against its CPU leg (every tick equal, 2 reads
    a tick, K1 and K2 once a tick and exact on the live tensors), and the
    overhead phases at both tables with K1 and K2 once a tick."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    K.build()
    launches, kernels = cs.phase_trace_lockstep(
        K, dev, cs.trace_lockstep_scenario(**LOCKSTEP, tables=cs.SOAK_TABLES), 1)
    assert launches["assign_count"] == launches["aoi"] == LOCKSTEP["ticks"]
    assert kernels["assign_count"]["max_abs_err"] == kernels["aoi"]["max_abs_err"] == 0
    out = cs.phase_overheads(K, dev, cs.trace_params(overhead_ticks=40, overhead_rounds=2),
                             cs.obs_params(overhead_ticks=30, overhead_rounds=2))
    assert set(out) == {"soak", "default"}
