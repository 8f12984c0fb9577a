"""Integer range-set parsing for FSM message whitelists/blacklists.

Capability parity with the reference FSM config format
(ref: pkg/fsm/fsm.go:76-171), where allowed/blocked message types are
written as comma-separated entries like ``"1"`` or ``"2-65535"``.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field


@dataclass
class RangeSet:
    """A set of non-negative integers stored as sorted inclusive ranges."""

    ranges: list[tuple[int, int]] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "RangeSet":
        """Parse ``"1,5,10-99"`` style specs. Empty string -> empty set."""
        ranges: list[tuple[int, int]] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "-" in part:
                lo_s, hi_s = part.split("-", 1)
                lo, hi = int(lo_s), int(hi_s)
                if hi < lo:
                    raise ValueError(f"invalid range: {part!r}")
            else:
                lo = hi = int(part)
            ranges.append((lo, hi))
        ranges.sort()
        # Coalesce overlapping/adjacent ranges so `contains` can bisect.
        merged: list[tuple[int, int]] = []
        for lo, hi in ranges:
            if merged and lo <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return cls(merged)

    def contains(self, value: int) -> bool:
        i = bisect_right(self.ranges, (value, float("inf")))
        return i > 0 and self.ranges[i - 1][1] >= value

    def __contains__(self, value: int) -> bool:
        return self.contains(value)

    def __bool__(self) -> bool:
        return bool(self.ranges)
