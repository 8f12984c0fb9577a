"""Delivery SLO plane: the number users experience, tracked in-process.

Every prior observability layer measures *internals* — per-stage tick
budgets (core/tracing.py), aggregate rates (core/metrics.py). None of
them measures the one number a player feels: how long an update takes
from the moment its bytes hit the gateway to the moment the fan-out
that carries it is sent. This module closes that gap and makes the
north-star "< 5ms p99 fan-out delivery at the live gateway" claim a
*live* measurement instead of a bench artifact:

- **End-to-end delivery latency.** ``core/connection.py`` stamps a
  monotonic ingest time on every externally-received message (the
  batched native fast path and the protobuf slow path both), the stamp
  rides the message context through channel dispatch and the update
  ring (``core/data.py``), and the fan-out send that delivers a window
  records ``delivery_latency_ms{channel_type,path}`` — one sample per
  delivered window, stamped with the NEWEST update it carries (the
  pipeline-transit reading; the cadence-held component is measured
  separately as staleness). Stamps survive backpressure stashes and
  overload-stretched intervals: a held-then-released delivery reports
  its true (large) latency, never a negative or dropped sample.
- **Fan-out staleness.** Once per GLOBAL tick, ONE round-robin channel
  with live data is sampled: for each subscriber priority class (the
  overload ladder's shed order) the age of the newest state that class
  has not yet been sent lands in
  ``fanout_staleness_ms{channel_type,sub_class}`` — bounded cost, and
  the honest counterweight to the delivery number (a browned-out
  observer is *stale*, not slow).
- **SLO tracker.** A declarative SLO table (delivery p99, tick budget
  utilization, trunk RTT, WAL fsync RPO by default; operators override
  via ``-slo-config``) is evaluated in-process every GLOBAL tick with
  multi-window burn rates: each SLO buckets good/bad events into
  per-second rings, and ``burn = bad_fraction / error_budget`` is
  exported per window (``slo_burn_rate{slo,window}``). A window whose
  burn crosses its alarm threshold fires a breach — counted
  double-entry (``slo_breaches_total{slo}`` + the python
  ``breach_counts`` ledger) on the rising edge, and each breach
  freezes a flight-recorder ``slo_breach`` anomaly dump so every SLO
  violation arrives with the tick timeline that caused it.

The plane is armed by ``-slo`` (default on for served gateways; soaks
with deterministic envelopes pin it off). Disabled, every hook is one
attribute load. See doc/observability.md.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..utils.logger import get_logger
from .affinity import affinity as _affinity

logger = get_logger("slo")

NS_PER_MS = 1_000_000

# Hot-path handle bound lazily on first use (channel.py imports this
# module at load, so importing channel here would cycle).
_all_channels = None


@dataclass
class SloSpec:
    """One declarative SLO row.

    ``source`` names the event stream feeding it (``delivery`` is fed
    by :meth:`SloPlane.record_delivery`; anything else by
    :meth:`SloPlane.observe` under that name). An event is *bad* when
    its value exceeds ``threshold`` (delivery/trunk_rtt/wal_fsync in
    ms; tick_budget in budget-utilization units). ``objective`` is the
    allowed good fraction (0.99 -> a 1% error budget); ``windows`` are
    the burn-rate evaluation horizons in seconds; ``burn_alarm`` is
    the per-window burn-rate multiple that fires a breach.
    """

    name: str
    source: str
    threshold: float
    objective: float = 0.99
    windows: tuple = (60, 300)
    burn_alarm: float = 1.0
    # Events below which a window is not judged (a single bad sample
    # in an idle second must not alarm a 99% objective).
    min_events: int = 20


def default_slos() -> list[SloSpec]:
    """The gateway's built-in SLO table (doc/observability.md)."""
    from .settings import global_settings as st

    return [
        # The north-star clause: ingest->fan-out delivery under 5ms.
        SloSpec(name="delivery_p99", source="delivery", threshold=5.0,
                objective=0.99, windows=(60, 300), burn_alarm=1.0),
        # A tick that overruns its interval ate someone's latency.
        SloSpec(name="tick_budget", source="tick_budget", threshold=1.0,
                objective=0.99, windows=(60, 300), burn_alarm=1.0),
        # Inter-gateway control-plane health (doc/federation.md).
        SloSpec(name="trunk_rtt", source="trunk_rtt", threshold=50.0,
                objective=0.99, windows=(60, 300), burn_alarm=1.0,
                min_events=5),
        # Durability RPO: one fsync batch (doc/persistence.md).
        SloSpec(name="wal_fsync_rpo", source="wal_fsync",
                threshold=max(st.wal_fsync_ms * 4.0, 50.0),
                objective=0.99, windows=(60, 300), burn_alarm=1.0,
                min_events=5),
    ]


def load_slo_config(path: str) -> list[SloSpec]:
    """Operator SLO table: a JSON list of SloSpec field dicts."""
    with open(path) as f:
        rows = json.load(f)
    specs = []
    for row in rows:
        row = dict(row)
        if "windows" in row:
            row["windows"] = tuple(int(w) for w in row["windows"])
        specs.append(SloSpec(**row))
    return specs


class _WindowRing:
    """Per-second (good, bad) buckets over the largest window; burn
    rates for smaller windows read a suffix. Observers may run on
    other threads (the WAL writer, trunk reads) — a small lock guards
    the bucket map; the per-event cost is one dict update."""

    __slots__ = ("span", "buckets", "lock")

    def __init__(self, span_s: int):
        self.span = span_s
        self.buckets: dict[int, list] = {}  # second -> [good, bad]  # tpulint: shared=lock
        self.lock = threading.Lock()

    def add(self, second: int, bad: bool) -> None:
        with self.lock:
            b = self.buckets.get(second)
            if b is None:
                b = self.buckets[second] = [0, 0]
                # Amortized trim: drop seconds past the span.
                if len(self.buckets) > self.span + 2:
                    floor = second - self.span
                    for s in [s for s in self.buckets if s < floor]:
                        del self.buckets[s]
            b[bad] += 1

    def window_counts(self, now_second: int, window_s: int) -> tuple:
        """(good, bad) over the trailing ``window_s`` seconds."""
        good = bad = 0
        with self.lock:
            floor = now_second - window_s
            for s, (g, b) in self.buckets.items():
                if s > floor:
                    good += g
                    bad += b
        return good, bad


@dataclass
class _SloState:
    spec: SloSpec
    ring: _WindowRing
    # window seconds -> alarm currently firing (rising-edge breach
    # accounting: a sustained burn counts once until it clears).
    alarmed: dict[int, bool] = field(default_factory=dict)
    burn: dict[int, float] = field(default_factory=dict)


class SloPlane:
    """Process-wide SLO tracker (one instance: ``slo``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.enabled = False
        self._states: dict[str, _SloState] = {}
        self._by_source: dict[str, list[_SloState]] = {}
        # Python-side breach ledger; must match slo_breaches_total.
        self.breach_counts: dict[str, int] = {}
        self.breach_events: list[dict] = []
        # Delivery-latency python tally (soak cross-checks + cheap p99
        # without scraping): the ONE bucket-edge tuple shared with the
        # delivery_latency_ms histogram — a retune in metrics.py can
        # never silently diverge the two.
        from .metrics import DELIVERY_LATENCY_BUCKETS

        self.delivery_edges = DELIVERY_LATENCY_BUCKETS
        self.delivery_counts = [0] * (len(self.delivery_edges) + 1)
        self.delivery_total = 0
        self._delivery_children: dict[tuple, object] = {}
        self._staleness_children: dict[tuple, object] = {}
        # Round-robin staleness ring: channel ids with live data +
        # subscribers, rebuilt at the eval cadence; the per-tick sample
        # visits ONE entry (strictly bounded cost however many
        # channels exist).
        self._sample_ring: list[int] = []
        self._sample_pos = 0
        # Burn-rate evaluation cadence (rings bucket per second; tests
        # set 0.0 to evaluate on every tick).
        self.eval_interval_s = 1.0
        self._next_eval = 0.0
        self._epoch = time.monotonic()

    def configure(self, enabled: bool = True,
                  specs: Optional[list[SloSpec]] = None) -> None:
        self.reset()
        self.enabled = enabled
        if not enabled:
            return
        for spec in (specs if specs is not None else default_slos()):
            span = max(spec.windows)
            state = _SloState(spec=spec, ring=_WindowRing(span))
            for w in spec.windows:
                state.alarmed[w] = False
                state.burn[w] = 0.0
            self._states[spec.name] = state
            self._by_source.setdefault(spec.source, []).append(state)

    # ---- event intake (hot paths; guard on slo.enabled) ------------------

    def record_delivery(self, channel_type_name: str, path: str,
                        ingest_ns: int, now_ns: Optional[int] = None) -> None:
        """One delivered fan-out window whose newest update was stamped
        at ``ingest_ns`` (host monotonic). Clamped at zero: a stamp can
        never produce a negative sample, whatever clock the caller fed
        (the overload-stretch hold test pins this)."""
        if not self.enabled or ingest_ns <= 0:
            return
        if now_ns is None:
            now_ns = time.monotonic_ns()
        ms = max(now_ns - ingest_ns, 0) / NS_PER_MS
        child = self._delivery_children.get((channel_type_name, path))
        if child is None:
            from . import metrics

            child = metrics.delivery_latency_ms.labels(
                channel_type=channel_type_name, path=path)
            self._delivery_children[(channel_type_name, path)] = child
        child.observe(ms)
        # Python-side tally (linear scan over 11 edges; the branch
        # usually exits in the first few buckets).
        i = 0
        edges = self.delivery_edges
        while i < len(edges) and ms > edges[i]:
            i += 1
        self.delivery_counts[i] += 1
        self.delivery_total += 1
        self._feed("delivery", ms)

    def observe(self, source: str, value: float) -> None:
        """Feed one event into every SLO declared on ``source``
        (trunk_rtt ms, wal_fsync ms, tick_budget utilization, ...).
        Thread-safe; callers guard on ``slo.enabled``."""
        if not self.enabled:
            return
        self._feed(source, value)

    def _feed(self, source: str, value: float) -> None:
        states = self._by_source.get(source)
        if not states:
            return
        second = int(time.monotonic())
        for state in states:
            state.ring.add(second, value > state.spec.threshold)

    # ---- the per-tick evaluation -----------------------------------------

    def on_global_tick(self) -> None:
        """The staleness sample (every call) + the burn-rate evaluation
        (at ``eval_interval_s`` cadence — the rings bucket per second,
        so evaluating faster than 1Hz buys nothing and the window scan
        over every SLO would tax the tick); called from the GLOBAL
        channel tick (single-writer context). Disabled = no-op (call
        sites also guard)."""
        if not self.enabled:
            return
        _affinity.expect("tick-loop")
        now = time.monotonic()
        if now >= self._next_eval:
            self._next_eval = now + self.eval_interval_s
            self._rebuild_sample_ring()
            self._evaluate(now)
        self._sample_staleness()

    def _evaluate(self, now: float) -> None:
        from . import metrics
        from .tracing import recorder as _trace

        now_second = int(now)
        for name, state in self._states.items():
            spec = state.spec
            budget = max(1.0 - spec.objective, 1e-9)
            for w in spec.windows:
                good, bad = state.ring.window_counts(now_second, w)
                total = good + bad
                if total < spec.min_events:
                    # Not enough signal to judge; burn decays to zero
                    # and an active alarm clears (the traffic ended).
                    state.burn[w] = 0.0
                    state.alarmed[w] = False
                    metrics.slo_burn_rate.labels(
                        slo=name, window=f"{w}s").set(0.0)
                    continue
                burn = (bad / total) / budget
                state.burn[w] = burn
                metrics.slo_burn_rate.labels(
                    slo=name, window=f"{w}s").set(burn)
                firing = burn >= spec.burn_alarm
                if firing and not state.alarmed[w]:
                    state.alarmed[w] = True
                    self._count_breach(name)
                    detail = (f"{name}[{w}s] burn={burn:.2f} "
                              f"(bad {bad}/{total}, "
                              f"budget {budget:.4f})")
                    logger.warning("SLO breach: %s", detail)
                    self.breach_events.append({
                        "slo": name, "window_s": w,
                        "burn": round(burn, 3), "bad": bad,
                        "total": total,
                        "t": round(time.monotonic() - self._epoch, 3),
                    })
                    del self.breach_events[:-256]
                    if _trace.enabled:
                        # Every SLO violation ships with the frozen
                        # tick timeline that produced it — forced past
                        # the anomaly cooldown (breaches are rare by
                        # construction: rising-edge + min-events
                        # gated; a tick_budget anomaly storm on a
                        # saturated box must not eat their dump slot).
                        _trace.note_anomaly("slo_breach", detail,
                                            force=True)
                elif not firing:
                    state.alarmed[w] = False

    def _count_breach(self, name: str, n: int = 1) -> None:
        """Double-entry: the prometheus counter AND the python ledger
        (soaks assert they match exactly)."""
        self.breach_counts[name] = self.breach_counts.get(name, 0) + n
        from . import metrics

        metrics.slo_breaches.labels(slo=name).inc(n)

    # ---- staleness sampling ----------------------------------------------

    def _rebuild_sample_ring(self) -> None:
        """Refresh the staleness round-robin (channels with live data
        AND subscribers) — runs at the eval cadence, so the full
        channel scan is paid once a second, never per tick."""
        from .channel import all_channels

        self._sample_ring = [
            cid for cid, ch in all_channels().items()
            if ch.data is not None and ch.data.update_msg_buffer
            and ch.subscribed_connections
        ]

    def _sample_staleness(self) -> None:
        """One round-robin channel per GLOBAL tick: for each subscriber
        priority class, the age of the newest state that class has not
        yet been sent. O(one channel's subscribers) per tick — bounded
        whatever the world size (the candidate ring is rebuilt at the
        eval cadence)."""
        ring = self._sample_ring
        if not ring:
            return
        # Lazy one-time bind (channel imports slo at module load, so
        # the import must not run at OUR load — but paying the import
        # machinery per tick is measurable on the hot path).
        global _all_channels
        if _all_channels is None:
            from .channel import all_channels as _ac

            _all_channels = _ac
        channels = _all_channels()
        nxt = None
        # A ring entry can go stale between rebuilds (channel removed,
        # buffer drained): skip up to two per tick, still bounded.
        for _ in range(2):
            if not ring:
                return
            self._sample_pos %= len(ring)
            ch = channels.get(ring[self._sample_pos])
            self._sample_pos += 1
            if (ch is not None and not ch.is_removing()
                    and ch.data is not None and ch.data.update_msg_buffer
                    and ch.subscribed_connections):
                nxt = ch
                break
        if nxt is None:
            return
        data = nxt.data
        newest = data.update_msg_buffer[-1]
        newest_ns = newest.ingest_ns
        if newest_ns <= 0:
            return
        # One age for the whole channel (the newest ingest is shared);
        # the per-sub work is a dict get + two int compares — the
        # subscription's shed priority is precomputed at subscribe time
        # (core/subscription.py), never re-derived here.
        age_ms = max(time.monotonic_ns() - newest_ns, 0) / NS_PER_MS
        msg_index = data.msg_index
        per_class: dict[int, float] = {}
        for foc in nxt.fan_out_queue:
            conn = foc.conn
            if conn is None or conn.is_closing():
                continue
            if foc.last_message_index >= msg_index:
                continue  # fully delivered; nothing is stale for it
            cs = nxt.subscribed_connections.get(conn)
            if cs is None:
                continue
            per_class[cs.priority] = age_ms
        ct_name = nxt.channel_type.name
        for klass, age_ms in per_class.items():
            key = (ct_name, klass)
            child = self._staleness_children.get(key)
            if child is None:
                from . import metrics

                child = metrics.fanout_staleness_ms.labels(
                    channel_type=ct_name, sub_class=f"p{klass}")
                self._staleness_children[key] = child
            child.observe(age_ms)

    # ---- reporting -------------------------------------------------------

    def delivery_quantile(self, q: float) -> Optional[float]:
        """Quantile estimate (ms) from the python-side delivery tally
        (upper bucket edge, the conservative reading); None without
        samples."""
        total = self.delivery_total
        if not total:
            return None
        target = q * total
        acc = 0
        for i, n in enumerate(self.delivery_counts):
            acc += n
            if acc >= target:
                return (self.delivery_edges[i]
                        if i < len(self.delivery_edges)
                        else float("inf"))
        return float("inf")

    def status(self) -> dict:
        """Per-SLO burn/alarm snapshot for /introspect and the soaks.
        Runs on the ops HTTP thread: list() snapshots the table first
        (a concurrent configure() must degrade to a stale read, never a
        dict-changed-size error in a probe)."""
        out = {}
        for name, state in list(self._states.items()):
            out[name] = {
                "objective": state.spec.objective,
                "threshold": state.spec.threshold,
                "burn": {f"{w}s": round(state.burn[w], 3)
                         for w in state.spec.windows},
                "alarmed": {f"{w}s": state.alarmed[w]
                            for w in state.spec.windows},
                "breaches": self.breach_counts.get(name, 0),
            }
        return out

    def report(self) -> dict:
        return {
            "enabled": self.enabled,
            "slos": self.status(),
            "breach_counts": dict(self.breach_counts),
            "breach_events": list(self.breach_events),
            "delivery_total": self.delivery_total,
            "delivery_p50_ms": self.delivery_quantile(0.50),
            "delivery_p99_ms": self.delivery_quantile(0.99),
        }


# The process-wide plane. Hot-path hook sites hold a module reference
# and guard on ``slo.enabled`` — one attribute load while disarmed.
slo = SloPlane()


def configure_from_settings() -> None:
    """Apply the -slo / -slo-config flags (run_server boot path)."""
    from .settings import global_settings as st

    specs = None
    if st.slo_config:
        specs = load_slo_config(st.slo_config)
    slo.configure(enabled=st.slo_enabled, specs=specs)


def reset_slo() -> None:
    """Test hook."""
    slo.reset()
