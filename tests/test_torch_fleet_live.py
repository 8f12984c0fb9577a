"""The last live fleet paths through the port: phase 2 of the trace and obs
soaks and scripts/global_soak.py's three gateways.

``chip_smoke.py``'s phase 17 keeps (the test loads chip_smoke.py by path):

- the port's copies of the scripts' constants (TraceSoakParams' and
  ObsSoakParams' federation fields, the trunk timings both phase 2s boot
  with, the obs soak's settings hook, GlobalSoakParams, the global soak's
  shard ranges, id bases, entity-id start and settings hook, the check
  names): equal to the scripts' own, loaded by path (a hook or a call
  inside a script function is read from its source);
- the fleet's metric digests: two digests made from a seed go through both
  packages' ``federation/obs.py`` (``merge_digests``, and ``FleetObs``'s
  exposition and census after ``store_peer``) with the same result, byte
  for byte; the port's copy of the obs soak's exactness legs passes on them
  and names a perturbed value;
- the ``--live-child`` roles (17a's and 17b's gateway "b", 17c's "b" and
  "c"): each boots on the CPU, says READY, reports, exits, and loads no
  module of JAX or of the JAX package;
- each checker names the check a report breaks; the copy of
  scripts/check_artifacts.py's ``_check_global_soak`` agrees with it.

No live multi-process soak runs here (phase 17 runs them on the card).
One ``cuda`` case runs ``--fleet-live`` on the card.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_elastic import REPO, chip_smoke
from test_torch_fleet import script
from test_torch_gateway import JAX, PORT, port_globals

HOST_GRID = "StaticGrid2DSpatialController"


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield


def function_node(module, name: str) -> ast.AST:
    """The ``def`` (sync or async) of ``name`` in a loaded script's source."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    return next(n for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == name)


def fed_params_calls(module, fn: str) -> list:
    """The keyword constants of every ``fed.FedSoakParams(...)`` call in
    ``fn`` of a script."""
    return [{k.arg: ast.literal_eval(k.value) for k in node.keywords}
            for node in ast.walk(function_node(module, fn))
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "FedSoakParams"]


def hook_of(module, fn: str, **scope):
    """The nested ``hook`` of ``fn`` in a script, compiled with ``scope``."""
    node = next(n for n in ast.walk(function_node(module, fn))
                if isinstance(n, ast.FunctionDef) and n.name == "hook")
    ns = dict(scope)
    exec(compile(ast.Module(body=[node], type_ignores=[]), module.__file__, "exec"), ns)
    return ns["hook"]


def applied(hook) -> dict:
    gs = SimpleNamespace()
    hook(gs)
    return vars(gs)


def artifact_names(name: str) -> list:
    with open(os.path.join(REPO, name)) as f:
        return [c["name"] for c in json.load(f)["invariants"]["checks"]]


# ---- (a) the port's copies equal the scripts' own ---------------------------


def test_port_copies_of_the_phase2_parameters_equal_the_soaks():
    """TraceSoakParams' and ObsSoakParams' phase-2 fields, and the trunk
    timings each phase 2 boots both gateways with."""
    cs = chip_smoke()
    ts, obs = script("trace_soak"), script("obs_soak")
    for mine, theirs in ((cs.trace_fed_params(), ts.TraceSoakParams()),
                         (cs.obs_fed_params(), obs.ObsSoakParams())):
        assert mine == {key: getattr(theirs, key) for key in mine}
    for module in (ts, obs):
        for fn in ("remote_main", "run_federation_phase"):
            assert fed_params_calls(module, fn) == [cs.PHASE2_TRUNK], (module.__name__, fn)


def test_port_copy_of_the_obs_settings_hook_equals_the_soak():
    """The obs soak's phase-2 hook (the parent's at ObsSoakParams' epoch, the
    child's at its --epoch-ms default) applied to a settings object."""
    cs = chip_smoke()
    obs = script("obs_soak")
    p = obs.ObsSoakParams()
    mine = applied(cs.obs_fed_settings_hook(p.fed_epoch_ms))
    assert mine == applied(hook_of(obs, "run_federation_phase", p=p))
    assert mine == applied(hook_of(obs, "remote_main", args=SimpleNamespace(epoch_ms=200)))


def test_port_copies_of_the_global_soak_equal_the_script():
    """The entity-id start the census counts from, and the settings hook at
    other parameters than the defaults (test_torch_fleet.py holds
    GlobalSoakParams, the ranges, the id bases and the hook at the
    defaults)."""
    cs = chip_smoke()
    glob = script("global_soak")
    estart = [ast.literal_eval(n.value) for n in ast.walk(function_node(glob, "run_global_soak"))
              if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "estart"]
    assert estart == [cs.GLOBAL_ESTART]
    p = glob.GlobalSoakParams(epoch_ms=300, death_miss_epochs=3, imbalance_enter=1.5)
    assert applied(cs.global_settings_hook(cs.GlobalSoakParams(**dataclasses.asdict(p)))) == \
        applied(glob._settings_hook(p))


def test_port_check_names_are_the_scripts():
    """Each path's invariants under the names the scripts' artifacts list:
    the trace and obs soaks' federation checks in their order, all 14 of
    the global soak's."""
    cs = chip_smoke()
    trace, obs = artifact_names("TRACE_r11.json"), artifact_names("OBS_r15.json")
    assert [n for n in trace if n in cs.TRACE_FED_INVARIANTS] == list(cs.TRACE_FED_INVARIANTS)
    assert [n for n in obs if n in cs.OBS_FED_INVARIANTS] == list(cs.OBS_FED_INVARIANTS)
    assert "every_tick_stage_measured" in trace
    assert artifact_names("SOAK_GLOBAL_r12.json") == list(cs.GLOBAL_INVARIANTS)


# ---- (b) the fleet digest, held against JAX ----------------------------------


def obs_module(pkg: str):
    return importlib.import_module(f"{pkg}.federation.obs")


def label_key(labels: dict) -> str:
    return json.dumps(sorted(labels.items()), separators=(",", ":"))


def seeded_digest(seed: int) -> dict:
    """A gateway's metric digest in federation/obs.py's shape: every
    federated family, a few label sets each (some shared across seeds),
    integral counts as the registry holds them, cumulative buckets."""
    ob = obs_module(PORT)
    rng = np.random.default_rng(seed)
    counters, gauges, hists = {}, {}, {}
    for family in ob.FLEET_COUNTERS:
        rows = {}
        for i in range(int(rng.integers(1, 4))):
            labels = {"conn_type": ("SERVER", "CLIENT")[i % 2],
                      "msg_type": str(int(rng.integers(1, 4)))}
            rows[label_key(labels)] = float(rng.integers(0, 5000))
        counters[family] = rows
    for family in ob.FLEET_SUM_GAUGES:
        gauges[family] = {label_key({"kind": str(i)}): float(rng.integers(0, 64))
                          for i in range(int(rng.integers(1, 3)))}
    for family in ob.FLEET_HISTS:
        edges = ("1.0", "5.0", "25.0", "+Inf")
        counts = np.cumsum(rng.integers(0, 50, size=len(edges))).astype(float)
        hists[family] = {label_key({"path": "host"}): {
            "bucket": dict(zip(edges, counts.tolist())),
            "sum": float(rng.integers(0, 10_000)) / 8.0, "count": float(counts[-1])}}
    return {"counters": counters, "gauges": gauges, "hists": hists}


def fleet_views(pkg: str, digests: dict) -> tuple:
    """One package's FleetObs after ``store_peer`` of each digest, on a fixed
    clock and without a local refresh: (exposition text, census JSON)."""
    cs = chip_smoke()
    fleet = obs_module(pkg).FleetObs()
    with cs.FixedClock():
        for gw, d in digests.items():
            fleet.store_peer(gw, json.dumps(d).encode())
        fleet._local_refreshed = math.inf  # render the stored digests only
        return fleet.render_prometheus(), fleet.render_json()


DIGESTS = {"a": seeded_digest(20260804), "b": seeded_digest(20260805)}


def test_fleet_digest_merge_and_render_equal_jax():
    """merge_digests, and /fleet's exposition and census after store_peer,
    are the JAX package's: the same merged digest, the same bytes."""
    jx, pt = obs_module(JAX), obs_module(PORT)
    assert (jx.FLEET_COUNTERS, jx.FLEET_SUM_GAUGES, jx.FLEET_HISTS) == (
        pt.FLEET_COUNTERS, pt.FLEET_SUM_GAUGES, pt.FLEET_HISTS)
    both = [DIGESTS["a"], DIGESTS["b"]]
    merged = pt.merge_digests(copy.deepcopy(both))
    assert merged == jx.merge_digests(copy.deepcopy(both))
    text_port, json_port = fleet_views(PORT, DIGESTS)
    text_jax, json_jax = fleet_views(JAX, DIGESTS)
    assert text_port == text_jax
    assert json_port == json_jax
    assert json_port["merged"] == merged
    assert "fleet_gateways 2" in text_port


def test_port_exactness_check_passes_on_the_fleet_and_names_a_perturbed_value():
    """The port's copy of the obs soak's exactness legs on /fleet rendered
    from the two digests: exact (every counter label set checked, parsed as
    the script parses it); one perturbed value in the rendered text or in
    the stored copy is named."""
    cs = chip_smoke()
    obs = script("obs_soak")
    pt = obs_module(PORT)
    text, _ = fleet_views(PORT, DIGESTS)
    rendered = cs.parse_exposition(text)
    assert rendered == obs.parse_exposition(text)
    a, b = DIGESTS["a"], DIGESTS["b"]
    mismatches, checked = cs.fleet_exactness(pt.merge_digests, b, b, a, rendered)
    assert mismatches == []
    assert checked == sum(len(rows) for rows in pt.merge_digests([a, b])["counters"].values())
    key = next(k for k in rendered if k[0] == "fleet_messages_in_total")
    bad = {**rendered, key: rendered[key] + 1.0}
    mismatches, _ = cs.fleet_exactness(pt.merge_digests, b, b, a, bad)
    assert len(mismatches) == 1 and "fleet_messages_in_total" in mismatches[0]
    stored = copy.deepcopy(b)
    family = next(iter(stored["gauges"]))
    label = next(iter(stored["gauges"][family]))
    stored["gauges"][family][label] += 2.0
    mismatches, _ = cs.fleet_exactness(pt.merge_digests, b, stored, a, rendered)
    assert mismatches == [f"gauges:{family}{label} self={b['gauges'][family][label]} "
                          f"stored={stored['gauges'][family][label]}"]


# ---- (c) the --live-child roles ----------------------------------------------

CHILDREN = {"trace": ("b", dict(fed_burst=10, fed_sever_burst=10, seed=20260803)),
            "obs": ("b", dict(fed_run_s=8.0, fed_epoch_ms=200, seed=20260804)),
            "global": ("c", None)}
REPORT_KEYS = {"trace": {"ledger", "spans"}, "obs": {"digest"},
               "global": {"ledger", "control", "placement", "forensics", "pending", "parked",
                          "journal", "events"}}


@pytest.mark.parametrize("role", sorted(CHILDREN))
def test_live_child_boots_reports_and_imports_neither_jax_nor_the_jax_package(role, tmp_path):
    """``chip_smoke.py --live-child ROLE GW CONFIG REPORT PARAMS`` (no card):
    it boots its shard on the host grid on ephemeral ports, says READY with
    its boot's parts, reports, exits; no module of JAX, of the JAX package or
    of torch is loaded in its process (ROADMAP F27). Each case is killed
    after 60 s."""
    cs = chip_smoke()
    gw, params = CHILDREN[role]
    if role == "global":
        params = dataclasses.asdict(cs.GlobalSoakParams())
        ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client", "c_trunk", "c_client"),
                         cs.fed_free_ports(6)))
        cfg = cs.fed_config3(ports)
    else:
        cfg = cs.fed_config(dict(zip(("a_trunk", "a_client", "b_trunk", "b_client"),
                                     cs.fed_free_ports(4))))
    config, report = tmp_path / "fed.json", tmp_path / "report.json"
    config.write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    with open(tmp_path / "child.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--live-child", role, gw,
             str(config), str(report), json.dumps(params)], cwd=REPO, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=log, text=True, env=env)
    timer = threading.Timer(60.0, proc.kill)
    timer.start()
    try:
        ready = None
        while ready is None:
            line = proc.stdout.readline()
            assert line, (tmp_path / "child.log").read_text()[-2000:]
            if line.startswith("READY"):
                ready = json.loads(line[len("READY"):])
        for cmd in ("report", "exit"):
            proc.stdin.write(json.dumps({"cmd": cmd}) + "\n")
            proc.stdin.flush()
        assert proc.wait(timeout=30) == 0
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert ready["modules"] == [] and "torch" not in ready["modules"]
    assert min(ready[k] for k in ("imports_s", "modules_s", "gateway_s")) > 0
    r = json.loads(report.read_text())
    assert r["modules"] == [] and r["spatial"] == HOST_GRID and r["gateway"] == gw
    assert REPORT_KEYS[role] <= set(r)


# ---- (d) each checker names the check a report breaks ------------------------

TRACE_FED = dict(trunk_stage={"count": 31, "mean_ms": 0.2, "p50_ms": 0.2, "p99_ms": 0.5},
                 committed=10, severed=True, aborted=4, stitched_traces=24, example=None,
                 abort_dumps=[{"trigger": "handover_abort", "perfetto_valid": True}],
                 trunk_stage_samples=31, boot={"b": {"modules": []}}, b_modules=[],
                 spatial=[HOST_GRID, HOST_GRID])
TRACE_LIVE = dict(stages={s: {"count": 5} for s in ("messages", "fanout", "device_step",
                                                     "readback", "follow_interests",
                                                     "handover", "overload")},
                  batched_ingest=False)
TRACE_BREAKS = {
    "every_tick_stage_measured": dict(trunk_stage={}),
    "cross_gateway_trace_stitched": dict(stitched_traces=0),
    "cross_gateway_committed": dict(committed=0),
    "trunk_stage_measured": dict(trunk_stage_samples=0),
    "handover_abort_anomaly_dumped": dict(abort_dumps=[{"trigger": "handover_abort",
                                                        "perfetto_valid": False}]),
    "child_imports_no_jax": dict(b_modules=["jax"]),
    "both_gateways_on_the_host_grid": dict(spatial=[HOST_GRID, "GPUSpatialController"])}
OBS_FED = dict(digest_exact=True, mismatches=[], labelsets_checked=27,
               gateways_in_fleet=["a", "b"], fleet_json_ok=True, leader="a",
               boot={"b": {"modules": []}}, b_modules=[], spatial=[HOST_GRID, HOST_GRID])
OBS_BREAKS = {
    "fleet_digest_exact": dict(digest_exact=False, mismatches=["x"]),
    "fleet_labelsets_checked": dict(labelsets_checked=20),
    "fleet_json_and_leader": dict(leader=""),
    "child_imports_no_jax": dict(boot={"b": {"modules": ["channeld_tpu"]}}),
    "both_gateways_on_the_host_grid": dict(spatial=["GPUSpatialController", HOST_GRID])}


def global_report() -> dict:
    cs = chip_smoke()
    control = dict(adoptions=0, deaths=1, counters={})
    return {
        "invariants": {"ok": True, "checks": [{"name": n, "ok": True, "detail": ""}
                                              for n in cs.GLOBAL_INVARIANTS]},
        "census": {"expected": 66, "missing": [], "duplicated": {}, "unexpected": []},
        "migration": {"committed": 2},
        "adoption": {"a": dict(control), "b": dict(control, adoptions=1)},
        "gateways": {"a": {"spatial": HOST_GRID}, "b": {"spatial": HOST_GRID, "modules": []}},
        "boot": {"b": {"modules": []}, "c": {"modules": []}}}


GLOBAL_EXTRA_BREAKS = {
    "all_14_invariants_checked": "drop",
    "check_artifacts_global_soak": lambda r: r["migration"].update(committed=0),
    "exactly_one_adoption": lambda r: r["adoption"]["a"].update(adoptions=1),
    "children_import_no_jax": lambda r: r["boot"]["c"].update(modules=["jax"]),
    "every_gateway_on_the_host_grid":
        lambda r: r["gateways"]["b"].update(spatial="GPUSpatialController")}


def failed_names(checks: list) -> set:
    return {name for name, ok, _ in checks if not ok}


def test_each_fleet_live_checker_passes_its_unbroken_report():
    cs = chip_smoke()
    assert [n for n, _, _ in cs.trace_fed_checks(TRACE_FED, TRACE_LIVE)] == [
        "every_tick_stage_measured", *cs.TRACE_FED_INVARIANTS, "child_imports_no_jax",
        "both_gateways_on_the_host_grid"]
    assert failed_names(cs.trace_fed_checks(TRACE_FED, TRACE_LIVE)) == set()
    assert [n for n, _, _ in cs.obs_fed_checks(OBS_FED)][:3] == list(cs.OBS_FED_INVARIANTS)
    assert failed_names(cs.obs_fed_checks(OBS_FED)) == set()
    assert failed_names(cs.global_soak_checks(global_report())) == set()


@pytest.mark.parametrize("name", sorted(TRACE_BREAKS))
def test_trace_fed_checker_names_the_broken_check(name):
    cs = chip_smoke()
    assert failed_names(cs.trace_fed_checks(dict(TRACE_FED, **TRACE_BREAKS[name]),
                                            TRACE_LIVE)) == {name}


def test_trace_fed_stage_check_expects_13b_stages_and_ingest_with_the_codec():
    """Without one of 13b's stages, or without ingest where the native codec
    ran the batched ingest, ``every_tick_stage_measured`` fails (F19)."""
    cs = chip_smoke()
    stages = dict(TRACE_LIVE["stages"])
    del stages["readback"]
    for live in (dict(TRACE_LIVE, stages=stages), dict(TRACE_LIVE, batched_ingest=True)):
        assert failed_names(cs.trace_fed_checks(TRACE_FED, live)) == {
            "every_tick_stage_measured"}


@pytest.mark.parametrize("name", sorted(OBS_BREAKS))
def test_obs_fed_checker_names_the_broken_check(name):
    cs = chip_smoke()
    assert failed_names(cs.obs_fed_checks(dict(OBS_FED, **OBS_BREAKS[name]))) == {name}


@pytest.mark.parametrize("name", [*chip_smoke().GLOBAL_INVARIANTS, *sorted(GLOBAL_EXTRA_BREAKS)])
def test_global_soak_checker_names_the_broken_check(name):
    cs = chip_smoke()
    r = global_report()
    brk = GLOBAL_EXTRA_BREAKS.get(name)
    if brk is None:
        for c in r["invariants"]["checks"]:
            c["ok"] = c["name"] != name
    elif brk == "drop":
        r["invariants"]["checks"].pop()
    else:
        brk(r)
    assert failed_names(cs.global_soak_checks(r)) == {name}


def broken_reports() -> dict:
    def drop(name):
        def brk(r):
            r["invariants"]["checks"] = [c for c in r["invariants"]["checks"]
                                         if c["name"] != name]
        return brk

    cases = {"unbroken": lambda r: None,
             "census_missing": lambda r: r["census"].update(missing=["524300"]),
             "census_duplicated": lambda r: r["census"].update(duplicated={"524300": []}),
             "no_migration": lambda r: r["migration"].update(committed=0),
             "no_ledger_checks": lambda r: r["invariants"].update(checks=[
                 c for c in r["invariants"]["checks"] if "ledger" not in c["name"]]),
             "no_redirect_check": drop("redirect_resumed_on_adopter_without_reauth"),
             "empty": lambda r: r.clear()}
    out = {}
    for label, brk in cases.items():
        r = global_report()
        brk(r)
        out[label] = r
    with open(os.path.join(REPO, "SOAK_GLOBAL_r12.json")) as f:
        out["SOAK_GLOBAL_r12"] = json.load(f)
    return out


@pytest.mark.parametrize("label", sorted(broken_reports()))
def test_check_global_soak_copy_agrees_with_check_artifacts(label):
    cs = chip_smoke()
    ca = script("check_artifacts")
    r = broken_reports()[label]
    got = cs.check_global_soak(r)
    assert got == ca._check_global_soak(r)
    assert (got == []) == (label in ("unbroken", "SOAK_GLOBAL_r12"))


# ---- (e) on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_fleet_live_on_the_card():
    """``chip_smoke.py --fleet-live`` in process on the card: phases 1-3,
    13b and 13d, then 17a-17c with every check."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    assert chip_smoke().main_fleet_live() == 0
