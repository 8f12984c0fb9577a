"""The program's own spans: the port's flight recorder, read by the benchmark.

The recorder (``channeld_tpu_torch/core/tracing.py``) stamps its spans with
``recorder.now()``, ``time.monotonic_ns``; the benchmark's spans and the
device trace's host side (``devtime.DeviceWindow``) are on
``time.perf_counter``. On Linux both read CLOCK_MONOTONIC; ``clock_offset``
ties them through paired readings all the same, and ``events`` converts the
recorder's spans to perf_counter seconds.

``steps`` hands each steady step of a traced window (``rec["steps_a"]``) the
program spans that lie inside it (a span belongs to the step whose bounds
hold its midpoint); the metrics' readers take them from what the recorder
holds when they run. A run that writes more spans than a ring holds keeps
its newest steps only: the steps that began before the oldest span a ring
still holds are left out. A program that records none of the spans a metric reads (a tree older
than them) gives that metric nothing to read, and it reports nothing.

``with_program`` adds the program's spans to the benchmark's for the owners
of the device's idle gaps (``harness._gap_owners``), so that the innermost
span that owns a gap can be a stage of the program.
"""

from __future__ import annotations

import bisect
import time
from typing import NamedTuple, Optional

from .spans import Event


class ProgramSpan(NamedTuple):
    name: str
    t0: float  # perf_counter seconds
    t1: float
    count: Optional[int]


def recorder():
    from channeld_tpu_torch.core.tracing import recorder as rec

    return rec


def clock_offset(rec=None, pairs: int = 5) -> float:
    """Seconds to add to ``recorder.now() / 1e9`` for perf_counter seconds:
    the midpoint of the tightest of ``pairs`` perf_counter readings around
    one recorder reading."""
    rec = rec or recorder()
    best = None
    for _ in range(pairs):
        a = time.perf_counter()
        ns = rec.now()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) / 2 - ns / 1e9)
    return best[1]


def events(spans, offset: float) -> list[ProgramSpan]:
    """The complete spans among ``spans`` (dicts as ``recorder.snapshot()``
    gives them) on perf_counter seconds, by start."""
    out = [ProgramSpan(s["name"], s["start_ns"] / 1e9 + offset,
                       (s["start_ns"] + s["dur_ns"]) / 1e9 + offset, s.get("count"))
           for s in spans if s["kind"] == "X"]
    out.sort(key=lambda e: e.t0)
    return out


def held(rec=None) -> tuple[list[ProgramSpan], float]:
    """(every complete span the recorder holds, on perf_counter seconds;
    the time from which it holds every span written: -inf unless a ring
    overwrote some, else the latest of the rings' earliest held starts)."""
    rec = rec or recorder()
    spans = rec.snapshot()  # by start
    offset = clock_offset(rec)
    since = float("-inf")
    if rec.stats()["dropped"]:
        first: dict = {}
        for s in spans:
            first.setdefault(s["tid"], s["start_ns"])
        since = max(first.values()) / 1e9 + offset
    return events(spans, offset), since


def steps(steps_a: list, spans: list, since: float = float("-inf")) -> list[list]:
    """The program spans inside each step of ``steps_a`` (the bounds of its
    benchmark events) that began at or after ``since``: a list per step, in
    step order; the other steps are left out."""
    mids = [(e.t0 + e.t1) / 2 for e in spans]
    out = []
    for step in steps_a:
        if not step["events"]:
            continue
        lo = min(e.t0 for e in step["events"])
        hi = max(e.t1 for e in step["events"])
        if lo >= since:
            out.append(spans[bisect.bisect_left(mids, lo):bisect.bisect_right(mids, hi)])
    return out


def with_program(bench_events: list, t0: float, t1: float) -> list:
    """``bench_events`` and the recorder's spans that overlap [t0, t1], as
    ``Event``s, for ``harness._gap_owners``."""
    spans, _ = held()
    return list(bench_events) + [Event(e.name, "", e.t0, e.t1) for e in spans
                                 if e.t1 > t0 and e.t0 < t1]


def _held_steps(rec: dict) -> list[list]:
    if not rec.get("steps_a"):
        return []
    spans, since = held()
    return steps(rec["steps_a"], spans, since)


def mean_ms(rec: dict, names) -> Optional[float]:
    """Milliseconds a step in the spans named ``names`` (a name ending in
    ``.`` names every span it starts), mean over the held steps; None where
    no step holds one."""
    per = _held_steps(rec)
    if not any(_named(e.name, names) for s in per for e in s):
        return None
    return sum((e.t1 - e.t0) * 1e3 for s in per for e in s if _named(e.name, names)) / len(per)


def mean_count(rec: dict, name: str) -> Optional[float]:
    """The counts of the spans named ``name``, summed a step, mean over the
    held steps; None where no step holds one with a count."""
    per = _held_steps(rec)
    counts = [e.count for s in per for e in s if e.name == name and e.count is not None]
    if not counts:
        return None
    return sum(counts) / len(per)


def ns_per_count(rec: dict, name: str) -> Optional[float]:
    """Nanoseconds in the spans named ``name`` over their counts, over the
    held steps; None where they count nothing."""
    got = [e for s in _held_steps(rec) for e in s if e.name == name and e.count]
    total = sum(e.count for e in got)
    if not total:
        return None
    return sum(e.t1 - e.t0 for e in got) * 1e9 / total


def _named(name: str, names) -> bool:
    return any(name.startswith(n) if n.endswith(".") else name == n for n in names)
