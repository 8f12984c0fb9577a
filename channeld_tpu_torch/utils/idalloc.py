"""Id allocation with wraparound and occupancy checks.

Capability parity with the reference's generic id allocator
(ref: pkg/channeld/util.go:71-84 ``GetNextIdTyped``) and string hashing
(util.go ``HashString``).
"""

from __future__ import annotations

from typing import Callable, Optional


class IdAllocator:
    """Allocate the next free id in [lo, hi], scanning with wraparound.

    ``occupied`` is a predicate over candidate ids — the caller's live
    table is the source of truth, so no free-list drift is possible.
    """

    def __init__(self, lo: int, hi: int):
        if hi < lo:
            raise ValueError("hi < lo")
        self.lo = lo
        self.hi = hi
        self._next = lo

    def next_id(self, occupied: Callable[[int], bool]) -> Optional[int]:
        span = self.hi - self.lo + 1
        candidate = self._next
        for _ in range(span):
            if candidate > self.hi:
                candidate = self.lo
            if not occupied(candidate):
                self._next = candidate + 1
                return candidate
            candidate += 1
        return None


def hash_string(s: str) -> int:
    """FNV-1a 32-bit — a stable, dependency-free string hash for PIT keys."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def difference(a: list, b: list) -> list:
    """Elements of ``a`` not present in ``b`` (ref: util.go ``Difference``)."""
    bs = set(b)
    return [x for x in a if x not in bs]
