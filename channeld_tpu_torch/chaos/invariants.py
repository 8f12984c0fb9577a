"""Invariant checking over the gateway's own metrics.

The chaos soak's pass/fail story: after (and during) a fault-laden run,
the gateway must still satisfy hard invariants — no entity lost, exact
counter accounting, recovery inside its deadline, tick p99 bounded. The
checker reads the process metrics registry directly (the same numbers
/metrics serves) so the assertions are about what an operator would
actually observe.

Counters are process-cumulative, so a soak embedded in a longer-lived
process (the pytest smoke) snapshots a baseline with :func:`scrape` at
start and evaluates on the :func:`delta` — histogram buckets are
cumulative counters too, so quantiles computed from a delta reflect only
the soak's own observations.
"""

from __future__ import annotations

from typing import Optional


def scrape(registry=None) -> dict:
    """{(sample_name, (sorted label items)): value} for every sample in
    the metrics registry (defaults to the gateway registry)."""
    if registry is None:
        from ..core import metrics

        registry = metrics.registry
    out: dict = {}
    for family in registry.collect():
        for sample in family.samples:
            key = (sample.name, tuple(sorted(sample.labels.items())))
            out[key] = sample.value
    return out


def delta(now: dict, base: dict) -> dict:
    """Per-sample ``now - base`` (samples absent from base count from 0).
    Meaningful for counters and histogram buckets; gauges keep their
    ``now`` reading by passing ``base={}``."""
    return {k: v - base.get(k, 0.0) for k, v in now.items()}


def sample_total(samples: Optional[dict], name: str, **label_filter) -> float:
    """Sum of every sample called ``name`` whose labels include
    ``label_filter`` (Counter samples end in ``_total``). ``samples``
    None scrapes the live registry."""
    if samples is None:
        samples = scrape()
    want = set(label_filter.items())
    total = 0.0
    for (sname, labels), value in samples.items():
        if sname == name and want.issubset(set(labels)):
            total += value
    return total


def histogram_quantile(
    samples: Optional[dict], name: str, q: float, **label_filter
) -> Optional[float]:
    """Estimate the q-quantile of a prometheus Histogram from its
    cumulative buckets (linear interpolation inside the bucket — the
    same estimate PromQL's histogram_quantile gives). None with no
    observations."""
    if samples is None:
        samples = scrape()
    want = set(label_filter.items())
    buckets: list[tuple[float, float]] = []
    for (sname, labels), value in samples.items():
        if sname != f"{name}_bucket":
            continue
        ld = dict(labels)
        le = ld.pop("le", None)
        if le is None or not want.issubset(set(ld.items())):
            continue
        buckets.append((float("inf") if le == "+Inf" else float(le), value))
    if not buckets:
        return None
    buckets.sort()
    total = buckets[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_le, prev_count = 0.0, 0.0
    for le, count in buckets:
        if count >= target:
            if le == float("inf"):
                return prev_le  # everything above the last finite bucket
            span = count - prev_count
            frac = (target - prev_count) / span if span > 0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_count = le, count
    return buckets[-1][0]


class InvariantChecker:
    """Accumulates named pass/fail checks into a report dict."""

    def __init__(self):
        self.results: list[dict] = []

    def check(self, name: str, ok: bool, detail: str = "") -> bool:
        self.results.append({"name": name, "ok": bool(ok), "detail": detail})
        return bool(ok)

    def expect_equal(self, name: str, got, want, detail: str = "") -> bool:
        return self.check(
            name, got == want,
            f"got={got} want={want}" + (f" ({detail})" if detail else ""),
        )

    def expect_le(self, name: str, got, bound, detail: str = "") -> bool:
        return self.check(
            name, got is not None and got <= bound,
            f"got={got} bound={bound}" + (f" ({detail})" if detail else ""),
        )

    def expect_gt(self, name: str, got, floor, detail: str = "") -> bool:
        return self.check(
            name, got is not None and got > floor,
            f"got={got} floor={floor}" + (f" ({detail})" if detail else ""),
        )

    @property
    def ok(self) -> bool:
        return all(r["ok"] for r in self.results)

    def summary(self) -> dict:
        return {"ok": self.ok, "checks": self.results}
