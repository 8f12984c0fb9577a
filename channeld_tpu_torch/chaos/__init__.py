"""Deterministic fault-injection layer (chaos engineering for the gateway).

Injection points are threaded through the transport reactors, the
connection/channel backpressure machinery, the KCP wire ARQ, and the
device decision plane; a seeded :class:`Scenario` schedules which faults
fire and when, and every fire is journaled so failures replay exactly.
See doc/chaos.md for the catalog and the soak driver
(scripts/chaos_soak.py) that proves the degradation paths live.

The wire-protocol fuzzer (:mod:`channeld_tpu.chaos.fuzz`,
doc/edge_hardening.md) is the adversarial complement: seeded hostile
byte streams against a real in-process gateway, with minimized violating
inputs committed to tests/corpus/wire/ and replayed in tier-1.
"""

from .injector import POINTS, ChaosInjector, arm, arm_from_file, chaos, disarm
from .invariants import InvariantChecker
from .scenario import FaultRule, Scenario

__all__ = [
    "POINTS",
    "ChaosInjector",
    "InvariantChecker",
    "FaultRule",
    "Scenario",
    "arm",
    "arm_from_file",
    "chaos",
    "disarm",
]
