"""Deterministic fault injector: the process-wide chaos singleton.

Hooks threaded through the stack call ``chaos.fire(point)`` /
``chaos.stall_s(point)`` at their injection point; when the injector is
disarmed (the default, and the only state production code ever runs in)
the hooks cost one attribute load. When armed with a
:class:`~channeld_tpu.chaos.scenario.Scenario`, each point keeps its own
call counter and its own seeded RNG, so a fault schedule replays exactly
for a given per-point call sequence — the interleaving of *other* points
cannot shift it. Every fire is journaled (point, call index, fire
ordinal, relative time) so a soak artifact records precisely which
faults hit and a failing run can be replayed.

This module imports only the standard library (plus a lazy metrics
import at fire time), so any layer of the stack can hook it without
import cycles.
"""

from __future__ import annotations

import time
import zlib
from random import Random
from typing import Optional

from .scenario import FaultRule, Scenario

# Catalog of injection points threaded through the stack. Hook sites
# pass these exact names; scenarios referencing an unknown point fail
# at arm time (a typo'd rule that silently never fires would make a
# "passing" chaos run meaningless).
POINTS = {
    # transport plane (core/server.py reactors)
    "transport.reset": "abort the socket before processing the read",
    "transport.truncate": "feed a partial read, then reset (peer died mid-frame)",
    "transport.corrupt": "flip a header byte (exercises the fatal framing path)",
    # connection plane (core/server.py + core/channel.py)
    "connection.eof_race": "close right after a read (EOF races deferred ingest)",
    "connection.queue_full": "report the target channel queue full (backpressure stash)",
    # channel runtime (core/channel.py)
    "channel.tick_budget": "stall inside message handling (tick-budget exhaustion)",
    # KCP wire ARQ (core/kcp.py)
    "kcp.loss": "drop an outbound datagram",
    "kcp.reorder": "hold an outbound datagram until after the next one",
    "kcp.dup": "duplicate an outbound datagram",
    # device plane (spatial/tpu_controller.py + core/device_guard.py)
    "device.dispatch_stall": "stall before the engine step (slow device dispatch)",
    "device.step_error": "raise a transient XLA-style error from the guarded step",
    "device.step_hang": "stall INSIDE the guarded step past the watchdog deadline",
    "device.nan": "corrupt device state (NaN positions + garbage cell baselines)",
    "device.rebuild_fail": "fail the in-process engine rebuild attempt",
    # simulation plane (channeld_tpu/sim/plane.py)
    "sim.step_nan": "rot the agent rows on device (NaN kinematics + "
                    "garbage cell baselines; the sentinel-triggered "
                    "rebuild must heal the population exactly)",
    "sim.stampede": "herd every agent toward one cell (deterministic "
                    "handover/density burst: exercises partition "
                    "splits and overload shedding from the sim plane)",
    # federation trunk plane (federation/trunk.py)
    "trunk.egress_drop": "drop an outbound trunk frame (lossy inter-gateway link)",
    "trunk.sever": "abort the trunk socket before the write (link partition)",
    # durable persistence plane (core/wal.py)
    "wal.torn_write": "write only a prefix of a WAL record (power loss "
                      "mid-append; replay must truncate at the bad CRC)",
    "wal.fsync_stall": "stall the off-thread writer before fsync (slow "
                       "disk; the tick path must stay unaffected)",
}


class _PointState:
    __slots__ = ("rule", "rng", "calls", "fires", "burst_left")

    def __init__(self, rule: FaultRule, seed: int):
        self.rule = rule
        self.rng = Random(seed ^ zlib.crc32(rule.point.encode()))
        self.calls = 0
        self.fires = 0
        self.burst_left = 0


class ChaosInjector:
    """Armed/disarmed fault gate. One instance per process (``chaos``)."""

    def __init__(self):
        self.armed = False
        self._points: dict[str, _PointState] = {}
        self._armed_at = 0.0
        self.scenario: Optional[Scenario] = None
        # Fired from every domain (tick-loop, WAL writer, device
        # worker): one GIL-atomic list append per event, read only by
        # soak teardown (doc/concurrency.md).
        self.journal: list[dict] = []  # tpulint: shared=atomic

    # ---- lifecycle -------------------------------------------------------

    def arm(self, scenario: Scenario) -> None:
        unknown = [r.point for r in scenario.faults if r.point not in POINTS]
        if unknown:
            raise ValueError(f"unknown chaos points: {unknown}")
        self._points = {
            r.point: _PointState(r, scenario.seed) for r in scenario.faults
        }
        self.scenario = scenario
        self.journal = []
        self._armed_at = time.monotonic()
        self.armed = True

    def disarm(self) -> None:
        self.armed = False
        self._points = {}
        self.scenario = None

    # ---- fault gates -----------------------------------------------------

    def fire(self, point: str) -> bool:
        """Count one call of ``point``; True when the fault fires."""
        st = self._points.get(point)
        if st is None:
            return False
        st.calls += 1
        rule = st.rule
        if rule.max_fires is not None and st.fires >= rule.max_fires:
            st.burst_left = 0  # the cap is hard; a burst never exceeds it
            return False
        if st.burst_left > 0:
            st.burst_left -= 1
            self._record(st, point)
            return True
        if rule.start_at_s > 0.0 or rule.stop_at_s != float("inf"):
            t = time.monotonic() - self._armed_at
            if not (rule.start_at_s <= t <= rule.stop_at_s):
                return False
        triggered = False
        if rule.every_n and st.calls % rule.every_n == 0:
            triggered = True
        elif rule.rate and st.rng.random() < rule.rate:
            triggered = True
        if not triggered:
            return False
        st.burst_left = rule.burst - 1
        self._record(st, point)
        return True

    def stall_s(self, point: str) -> float:
        """Stall duration in seconds when the point fires, else 0."""
        if not self.fire(point):
            return 0.0
        st = self._points[point]
        return st.rule.stall_ms / 1000.0

    def _record(self, st: _PointState, point: str) -> None:
        st.fires += 1
        self.journal.append({
            "point": point,
            "call": st.calls,
            "fire": st.fires,
            "t": round(time.monotonic() - self._armed_at, 4),
        })
        try:  # lazy: metrics must not be a hard dependency of the injector
            from ..core import metrics

            metrics.chaos_faults.labels(point=point).inc()
        except Exception:
            pass

    # ---- reporting -------------------------------------------------------

    def fire_counts(self) -> dict[str, int]:
        return {p: st.fires for p, st in self._points.items()}

    def report(self) -> dict:
        """Journal + per-point counts, for soak artifacts."""
        return {
            "scenario": self.scenario.to_dict() if self.scenario else None,
            "fire_counts": self.fire_counts(),
            "call_counts": {p: st.calls for p, st in self._points.items()},
            "journal": list(self.journal),
        }


# The process-wide injector. Hook sites hold a module reference and check
# ``chaos.armed`` inline; tests and the soak driver arm/disarm it.
chaos = ChaosInjector()


def arm(scenario_or_dict) -> None:
    if isinstance(scenario_or_dict, dict):
        scenario_or_dict = Scenario.from_dict(scenario_or_dict)
    chaos.arm(scenario_or_dict)


def arm_from_file(path: str) -> None:
    chaos.arm(Scenario.load(path))


def disarm() -> None:
    chaos.disarm()
