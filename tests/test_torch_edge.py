"""The abuse soak (the edge plane) through the port: ``chip_smoke.py``'s
phase 18.

``chip_host.py`` keeps the port's copy of scripts/abuse_soak.py's
``run_abuse_soak`` (the test loads chip_smoke.py, which imports it, by path):

- its copies of AbuseSoakParams, of the script's pins and edge knobs, of
  the attackers' loopback source ranges, of the hostile-frame generator and
  of the invariant names equal the script's own (read from the script's
  source where they sit inside ``run_abuse_soak``);
- the malformed-frame sessions of each of the three attackers' seeded
  streams (``Random(seed ^ (0x600D + i))``), fed frame by frame through a
  client connection of each package on a fake transport, end the same way
  session by session: closed or not, the four edge ledgers, the edge
  counters and the bans. The JAX package frames with its prebuilt
  ``_codec``; the port with the codec it builds from ``native/codec.cc``,
  and with its pure-Python framing (``framing._native = None``, as on the
  card's machine, which has no libsnappy);
- each checker names the check a report breaks; the copy of
  scripts/check_artifacts.py's ``_check_abuse_soak`` agrees with it.

No live soak, no listener and no wall clock here (phase 18 runs the soak;
ROADMAP's standing rule). One ``cuda`` case runs ``--edge`` on the card.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import json
import os
import struct
from random import Random

import pytest
import torch

from test_torch_elastic import REPO, chip_smoke
from test_torch_fleet import script
from test_torch_gateway import JAX, PORT, mod, port_globals

SESSIONS = 24  # malformed-frame sessions per attacker stream
EDGE_FAMILIES = {"quarantine_counts": ("conn_quarantine_total", "reason"),
                 "malformed_counts": ("malformed_frames_total", "stage"),
                 "egress_drop_counts": ("egress_dropped_total", "reason"),
                 "reap_counts": ("conn_reaped_total", "reason")}


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield


def host():
    return chip_smoke().chip_host


def soak_function() -> ast.AST:
    """``run_abuse_soak``'s ``def`` in the script's source."""
    with open(os.path.join(REPO, "scripts", "abuse_soak.py")) as f:
        tree = ast.parse(f.read())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.AsyncFunctionDef) and n.name == "run_abuse_soak")


def nested(name: str) -> ast.AST:
    return next(n for n in ast.walk(soak_function())
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == name)


# ---- (a) the copies equal the script's ------------------------------------------


def test_params_equal_the_scripts():
    assert dataclasses.asdict(host().AbuseSoakParams()) == dataclasses.asdict(
        script("abuse_soak").AbuseSoakParams())


def test_pins_and_edge_knobs_equal_the_scripts():
    """Every constant the script sets on ``global_settings`` (its side planes
    pinned off and its edge knobs); the auth deadline comes from the params."""
    pins = {}
    for node in ast.walk(soak_function()):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "global_settings"):
            value = node.value
            if isinstance(value, ast.Attribute):  # p.auth_deadline_ms
                assert ast.unparse(value) == "p.auth_deadline_ms"
                continue
            pins[node.targets[0].attr] = eval(compile(ast.Expression(value), "<knob>", "eval"),
                                              {"__builtins__": {}})
    assert pins == {**host().ABUSE_PINS, **host().EDGE_KNOBS}


def test_attacker_source_ranges_equal_the_scripts():
    def prefix(fn: str) -> str:
        strings = [n for n in ast.walk(nested(fn)) if isinstance(n, ast.JoinedStr)
                   and isinstance(n.values[0], ast.Constant)
                   and n.values[0].value.startswith("127.0.")]
        assert len(strings) == 1, fn
        return strings[0].values[0].value

    assert {cls: prefix(fn) for cls, fn in (("slow_reader", "_slow_reader"),
                                            ("malformed_frame", "_malformed_attacker"),
                                            ("connect_flood", "_connect_flood"))} == \
        host().ATTACKER_SOURCES


def test_invariant_names_equal_the_scripts_in_order():
    calls = sorted((c.lineno, c.args[0].value) for c in ast.walk(soak_function())
                   if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                   and isinstance(c.func.value, ast.Name) and c.func.value.id == "inv"
                   and c.args and isinstance(c.args[0], ast.Constant))
    assert [n for _, n in calls] == list(host().ABUSE_INVARIANTS)


@pytest.mark.parametrize("i", range(3))
def test_hostile_frames_equal_the_scripts(i):
    """The script's nested ``_hostile_bytes`` and the copy draw the same
    frames from attacker ``i``'s stream, and the stream is seeded as the
    script's ``Random(p.seed ^ (0x600D + i))``."""
    ns = {"struct": struct, "Random": Random, "bytes": bytes}
    exec(compile(ast.Module(body=[nested("_hostile_bytes")], type_ignores=[]), "abuse_soak.py",
                 "exec"), ns)
    p = host().AbuseSoakParams()
    theirs, mine = Random(p.seed ^ (0x600D + i)), host().malformed_rng(p, i)
    assert [ns["_hostile_bytes"](theirs) for _ in range(300)] == [
        host().hostile_bytes(mine) for _ in range(300)]


# ---- (b) the malformed-frame sessions through both packages ----------------------


class FakeTransport:
    """An in-memory byte sink (``tests/helpers.FakeTransport``)."""

    def __init__(self):
        self.written: list = []
        self.closed = False

    def write(self, data: bytes) -> None:
        self.written.append(data)

    def close(self) -> None:
        self.closed = True

    def remote_addr(self):
        return ("127.0.2.1", 9999)


def sessions(i: int) -> list:
    """Attacker ``i``'s first SESSIONS sessions, each its frames, drawn as the
    soak draws them (the frame count, then each frame)."""
    hc = host()
    r = hc.malformed_rng(hc.AbuseSoakParams(), i)
    return [[hc.hostile_bytes(r) for _ in range(r.randrange(1, 4))] for _ in range(SESSIONS)]


def run_sessions(pkg: str, frames: list) -> dict:
    """Feed each session's frames into a fresh client connection of ``pkg``
    (the attacker closes its end after: EOF closes a lingering one); the
    outcome of each session, the edge ledgers, the edge counters and the
    bans."""
    from test_torch_gateway import fresh_runtime

    fresh_runtime(pkg)
    mod(pkg, "core.settings").global_settings.development = True
    connection, edge = mod(pkg, "core.connection"), mod(pkg, "core.edge")
    inv, types = mod(pkg, "chaos.invariants"), mod(pkg, "core.types")
    connection.set_fsm_templates(None, None)
    edge.reset_edge()
    baseline = inv.scrape()
    outcomes = []
    for session in frames:
        transport = FakeTransport()
        conn = connection.add_connection(transport, types.ConnectionType.CLIENT)
        closed_at = None
        for k, frame in enumerate(session):
            conn.on_bytes(frame)
            if closed_at is None and conn.is_closing():
                closed_at = k
        outcomes.append((closed_at, transport.closed, len(b"".join(transport.written))))
        if not conn.is_closing():
            conn.close()
    d = inv.delta(inv.scrape(), baseline)
    counters = {family: {dict(labels)[label]: int(v) for (name, labels), v in d.items()
                         if name == family and v}
                for family, label in EDGE_FAMILIES.values()}
    ledgers = {name: dict(getattr(edge.ledgers, name)) for name in EDGE_FAMILIES}
    banned, _ = mod(pkg, "core.ddos").blacklist_snapshot()
    connection.reset_connections()
    return dict(outcomes=outcomes, ledgers=ledgers, counters=counters, banned=sorted(banned))


def codec_of(pkg: str):
    return mod(pkg, "protocol.framing")._native


@pytest.mark.parametrize("setup", ["port-native", "port-pure"])
@pytest.mark.parametrize("i", range(3))
def test_malformed_sessions_end_alike_in_both_packages(i, setup, monkeypatch):
    """Attacker ``i``'s sessions through the JAX package (its prebuilt
    ``_codec``) and through the port (``port-native``: the codec built from
    its ``codec.cc``; ``port-pure``: its pure-Python framing): equal,
    session by session, ledger by ledger and counter by counter."""
    if codec_of(JAX) is None:
        pytest.skip("the JAX package's codec is not built")
    if setup == "port-native" and codec_of(PORT) is None:
        pytest.skip("the port's codec could not be built here (no g++ or libsnappy.so.1)")
    if setup == "port-pure":
        monkeypatch.setattr(mod(PORT, "protocol.framing"), "_native", None)
    frames = sessions(i)
    reference = run_sessions(JAX, frames)
    assert run_sessions(PORT, frames) == reference
    # The stream reaches the stages the soak's invariants read.
    assert reference["ledgers"]["malformed_counts"].get("framing", 0) > 0
    assert reference["ledgers"]["malformed_counts"] == reference["counters"][
        "malformed_frames_total"]
    assert any(closed is not None for closed, _, _ in reference["outcomes"])


# ---- (c) each checker names the check a report breaks ----------------------------


def abuse_report() -> dict:
    hc = host()
    expected = ["abuse-master", *(f"honest-{i}" for i in range(8))]
    ledgers = {"quarantine": {"slow_consumer": 3}, "malformed": {"framing": 72, "packet": 154},
               "egress_drops": {"slow_consumer": 210}, "reaps": {"auth_timeout": 3,
                                                                 "quarantine": 3}}
    return {
        "kind": "abuse_soak",
        "invariants": {"ok": True, "checks": [{"name": n, "ok": True, "detail": ""}
                                              for n in hc.ABUSE_INVARIANTS]},
        "attackers": {"classes": list(hc.ATTACKER_SOURCES)},
        "edge": copy.deepcopy(ledgers), "metrics": copy.deepcopy(ledgers),
        "census": {"expected": expected, "survivors": list(expected), "honest_disconnects": 0},
        "delivery": {"honest_clients": 8, "frames_sent": 4224, "frames_drained": 4224,
                     "missing": {}},
        "rss": {"base_mb": 85.0, "peak_mb": 85.1, "final_mb": 82.4, "growth_mb": 0.1,
                "bound_mb": 256.0},
        "boot": {"modules": []}, "modules": []}


EXTRA_BREAKS = {
    "all_22_invariants_checked":  # two checks out of the script's order
        lambda r: r["invariants"]["checks"].insert(1, r["invariants"]["checks"].pop(2)),
    "check_artifacts_abuse_soak": lambda r: r["delivery"].update(missing={"3": 2}),
    "child_loads_no_torch_and_no_jax": lambda r: r["boot"].update(modules=["torch"])}


def failed_names(checks: list) -> set:
    return {name for name, ok, _ in checks if not ok}


def test_abuse_checker_passes_its_unbroken_report():
    cs = chip_smoke()
    checks = cs.abuse_soak_checks(abuse_report())
    assert [n for n, _, _ in checks] == [*host().ABUSE_INVARIANTS, *EXTRA_BREAKS]
    assert failed_names(checks) == set()


@pytest.mark.parametrize("name", [*host().ABUSE_INVARIANTS, *EXTRA_BREAKS])
def test_abuse_checker_names_the_broken_check(name):
    cs = chip_smoke()
    r = abuse_report()
    if name in EXTRA_BREAKS:
        EXTRA_BREAKS[name](r)
    else:
        for c in r["invariants"]["checks"]:
            c["ok"] = c["name"] != name
    assert failed_names(cs.abuse_soak_checks(r)) == {name}


def broken_reports() -> dict:
    def drop(name):
        def brk(r):
            r["invariants"]["checks"] = [c for c in r["invariants"]["checks"]
                                         if c["name"] != name]
        return brk

    cases = {"unbroken": lambda r: None,
             "census_short": lambda r: r["census"]["survivors"].pop(),
             "honest_disconnect": lambda r: r["census"].update(honest_disconnects=1),
             "delivery_missing": lambda r: r["delivery"].update(missing={"0": 1}),
             "nothing_sent": lambda r: r["delivery"].update(frames_sent=0),
             "rss_over": lambda r: r["rss"].update(growth_mb=300.0),
             "rss_unproven": lambda r: r["rss"].pop("growth_mb"),
             "two_classes": lambda r: r["attackers"]["classes"].pop(),
             "three_ledger_checks": drop("reap_ledger_matches_metric"),
             "no_flood_ban_check": drop("flood_sources_banned"),
             "empty": lambda r: r.clear()}
    out = {}
    for label, brk in cases.items():
        r = abuse_report()
        brk(r)
        out[label] = r
    with open(os.path.join(REPO, "SOAK_ABUSE_r16.json")) as f:
        out["SOAK_ABUSE_r16"] = json.load(f)
    return out


@pytest.mark.parametrize("label", sorted(broken_reports()))
def test_check_abuse_soak_copy_agrees_with_check_artifacts(label):
    cs = chip_smoke()
    r = broken_reports()[label]
    got = cs.check_abuse_soak(r)
    assert got == script("check_artifacts")._check_abuse_soak(r)
    assert (got == []) == (label in ("unbroken", "SOAK_ABUSE_r16"))


# ---- (d) on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_edge_on_the_card():
    """``chip_smoke.py --edge`` in process on the card: phases 1-3, then 18
    (its soak in a ``--edge-child`` process) with every check."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    assert chip_smoke().main_edge() == 0
