"""Chaos scenario spec: which faults fire, where, and on what schedule.

A scenario is a seed plus a list of fault rules. Each rule targets one
injection point (a dotted name like ``transport.reset``; the catalog of
points threaded through the stack lives in ``injector.POINTS``) and
fires on a deterministic schedule:

- ``every_n``: fire on every Nth *call* of the point (per-point call
  counters, so the schedule replays exactly for a given inbound
  sequence regardless of how unrelated points interleave).
- ``rate``: fire with probability ``rate`` per call, drawn from a
  per-point ``random.Random`` seeded from ``seed ^ crc32(point)`` —
  identical call sequences produce identical fault sequences.
- ``burst``: once triggered, keep firing for ``burst`` consecutive
  calls (models a sustained outage rather than a blip).
- ``start_at_s`` / ``stop_at_s``: wall-clock gates relative to arming,
  for live soaks (omit them in replay-exact unit scenarios).
- ``max_fires``: hard cap on total fires for the rule.
- ``stall_ms``: for stall-type points, how long the injected stall is.

JSON schema (see doc/chaos.md)::

    {
      "seed": 42,
      "config_overrides": {"CellBucket": 2},
      "faults": [
        {"point": "transport.reset", "every_n": 400, "max_fires": 6},
        {"point": "kcp.loss", "rate": 0.05},
        {"point": "channel.tick_budget", "every_n": 50, "stall_ms": 15}
      ]
    }

``config_overrides`` is not an injection rule: the soak driver merges it
into the spatial controller's ``Config`` (e.g. undersizing ``CellBucket``
to force the cells-plane overflow shed + re-offer path).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class FaultRule:
    point: str
    every_n: int = 0  # 0 = not call-scheduled
    rate: float = 0.0  # 0 = not probability-scheduled
    burst: int = 1  # consecutive calls per trigger
    start_at_s: float = 0.0
    stop_at_s: float = float("inf")
    max_fires: Optional[int] = None
    stall_ms: float = 0.0

    def __post_init__(self):
        if not self.point:
            raise ValueError("fault rule needs a point name")
        if self.every_n < 0 or self.burst < 1:
            raise ValueError(f"bad schedule for {self.point}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate out of [0,1] for {self.point}")
        if self.every_n == 0 and self.rate == 0.0:
            raise ValueError(
                f"rule for {self.point} needs every_n or rate to ever fire"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        # None is accepted wherever to_dict emits it (stop_at_s has no
        # JSON spelling for inf; max_fires None = uncapped), so a
        # SOAK_*.json artifact's embedded scenario replays as-is.
        stop = d.get("stop_at_s")
        max_fires = d.get("max_fires")
        return cls(
            point=d.get("point", ""),
            every_n=int(d.get("every_n", 0)),
            rate=float(d.get("rate", 0.0)),
            burst=int(d.get("burst", 1)),
            start_at_s=float(d.get("start_at_s", 0.0)),
            stop_at_s=float(stop) if stop is not None else float("inf"),
            max_fires=int(max_fires) if max_fires is not None else None,
            stall_ms=float(d.get("stall_ms", 0.0)),
        )


@dataclass
class Scenario:
    seed: int = 0
    faults: list[FaultRule] = field(default_factory=list)
    # Merged into the spatial controller Config by the soak driver
    # (e.g. {"CellBucket": 2} to force the overflow shed path).
    config_overrides: dict = field(default_factory=dict)
    name: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        return cls(
            seed=int(d.get("seed", 0)),
            faults=[FaultRule.from_dict(f) for f in d.get("faults", [])],
            config_overrides=dict(d.get("config_overrides", {})),
            name=str(d.get("name", "")),
        )

    @classmethod
    def load(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "config_overrides": self.config_overrides,
            "faults": [
                {
                    "point": r.point,
                    "every_n": r.every_n,
                    "rate": r.rate,
                    "burst": r.burst,
                    "start_at_s": r.start_at_s,
                    "stop_at_s": (
                        r.stop_at_s if r.stop_at_s != float("inf") else None
                    ),
                    "max_fires": r.max_fires,
                    "stall_ms": r.stall_ms,
                }
                for r in self.faults
            ],
        }
