"""Always-on flight recorder: tick-timeline tracing.

Aggregate Prometheus histograms answer "how slow was the gateway last
minute"; they cannot answer "where did THIS tick's budget go" or "what
happened to THAT handover as it crossed two gateways". The flight
recorder closes that gap as a permanent layer (CheetahGIS-style
streaming-spatial operation and Spider-style cross-node transactions
both presuppose correlated, low-overhead telemetry):

- **Fixed memory, lock-free on the hot path.** Spans live in per-thread
  ring buffers (``threading.local``; the asyncio runtime is effectively
  one writer per thread, so an index bump + list store is race-free).
  The ring never grows: overflow overwrites the OLDEST span and is
  counted exactly (``dropped``), so the recorder always holds the
  newest ticks — flight-recorder semantics, not a log.
- **Tick-scoped, sampling-free.** Every span is stamped with the
  current GLOBAL tick number (``set_tick`` from the GLOBAL channel
  tick). Tick-scoped stages are few per tick (ingest drain, message
  dispatch, fan-out encode, device step, readback, handover
  orchestration, trunk I/O), so recording each one costs two
  ``monotonic_ns`` reads and a ring store (~100-200ns) — cheap enough
  to never sample.
- **Trace ids across gateways.** A cross-gateway handover or client
  redirect carries its trace id over the trunk (``traceId`` on
  TrunkHandoverPrepare/Ack/StageRedirect), so one id stitches spans
  from both gateways' recorders into a single reconstructible trace.
- **Three exits**: ``dump_trace()`` writes Chrome/Perfetto
  ``trace_event`` JSON (open in ui.perfetto.dev or chrome://tracing —
  the same story as ``-profile tpu``); anomalies (tick-budget blow,
  overload transition, handover/migration abort, failover epoch)
  freeze the ring and auto-dump the last N ticks, counted in
  ``trace_dumps_total{trigger}``; and per-stage cost feeds the
  ``tick_stage_ms{stage}`` histograms whether or not span recording is
  enabled.

See doc/observability.md.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional

from ..utils.logger import get_logger
from .affinity import affinity as _affinity

logger = get_logger("tracing")

# Span kinds (trace_event "ph" values).
_COMPLETE = "X"
_INSTANT = "i"

_trace_counter = itertools.count(1)
_dump_counter = itertools.count(1)


def new_trace_id(prefix: str = "") -> str:
    """Process-unique trace id; ``prefix`` ties it to an origin (e.g.
    the federation gateway id) so a stitched cross-gateway trace shows
    where it started."""
    return f"{prefix or 'g'}-{os.getpid():x}-{next(_trace_counter):x}"


class _Ring:
    """Fixed-capacity span store for ONE writer thread. Overflow
    overwrites the oldest entry and bumps ``dropped`` — the recorder
    keeps the newest spans with exact drop accounting."""

    __slots__ = ("buf", "cap", "idx", "count", "dropped", "tid")

    def __init__(self, cap: int, tid: int):
        self.cap = cap
        self.buf: list = [None] * cap
        self.idx = 0  # next write position
        self.count = 0  # live entries (<= cap)
        self.dropped = 0  # entries overwritten by wrap
        self.tid = tid

    def put(self, entry: tuple) -> None:
        i = self.idx
        # Entry lands BEFORE the count bump: a cross-thread snapshot
        # reading buf[:count] must never see a not-yet-stored slot.
        self.buf[i] = entry
        if self.count == self.cap:
            self.dropped += 1
        else:
            self.count += 1
        self.idx = (i + 1) % self.cap

    def snapshot(self) -> list:
        """Entries oldest-first (freeze-and-copy; O(cap))."""
        if self.count < self.cap:
            return [e for e in self.buf[: self.count]]
        return self.buf[self.idx:] + self.buf[: self.idx]


class FlightRecorder:
    """Process-wide recorder (one instance: ``recorder``).

    Hot-path contract: call sites guard on ``recorder.enabled`` (one
    attribute load while disabled) and use ``now()`` + ``span()`` /
    ``stage()`` / ``instant()``. Entries are tuples
    ``(kind, name, lane, start_ns, dur_ns, tick, trace_id)``.
    """

    def __init__(self):
        self._local = threading.local()
        self._rings: dict[int, _Ring] = {}
        self._rings_lock = threading.Lock()
        self.configure()

    # ---- configuration ---------------------------------------------------

    def configure(
        self,
        enabled: bool = True,
        ring_spans: int = 8192,
        dump_ticks: int = 200,
        dump_path: str = "profiles",
        anomaly_cooldown_s: float = 5.0,
        origin: str = "",
    ) -> None:
        self.enabled = enabled
        self.ring_spans = max(16, int(ring_spans))
        self.dump_ticks = max(1, int(dump_ticks))
        self.dump_path = dump_path
        self.anomaly_cooldown_s = anomaly_cooldown_s
        self.origin = origin
        self.tick = 0
        self.anomalies: list[dict] = []
        self._last_dump_at = -1e9
        with self._rings_lock:
            self._rings.clear()
        self._local = threading.local()
        self._epoch_ns = time.monotonic_ns()

    def reset(self) -> None:
        """Test hook: drop every ring and restore defaults."""
        self.configure()

    # ---- hot path --------------------------------------------------------

    @staticmethod
    def now() -> int:
        return time.monotonic_ns()

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self.ring_spans, threading.get_ident())
            self._local.ring = ring
            with self._rings_lock:
                self._rings[ring.tid] = ring
        return ring

    def span(self, name: str, start_ns: int, lane: int = 0,
             trace: Optional[str] = None,
             end_ns: Optional[int] = None) -> None:
        """Record one complete span that began at ``start_ns`` (from
        :meth:`now`) and ends now (or at ``end_ns``)."""
        if not self.enabled:
            return
        if end_ns is None:
            end_ns = time.monotonic_ns()
        self._ring().put((
            _COMPLETE, name, lane, start_ns, end_ns - start_ns,
            self.tick, trace,
        ))

    def instant(self, name: str, lane: int = 0,
                trace: Optional[str] = None) -> None:
        if not self.enabled:
            return
        self._ring().put((
            _INSTANT, name, lane, time.monotonic_ns(), 0, self.tick, trace,
        ))

    def stage(self, stage: str, start_ns: int, lane: int = 0,
              trace: Optional[str] = None,
              end_ns: Optional[int] = None) -> None:
        """A named per-tick stage: records the span AND observes the
        ``tick_stage_ms{stage}`` histogram (the histogram moves even
        with span recording disabled, so live dashboards keep their
        per-stage budgets either way). ``end_ns`` overrides "now" for
        aggregated stages (e.g. the per-follower readback total)."""
        if end_ns is None:
            end_ns = time.monotonic_ns()
        _stage_ms(stage).observe((end_ns - start_ns) / 1e6)
        if self.enabled:
            self._ring().put((
                _COMPLETE, stage, lane, start_ns, end_ns - start_ns,
                self.tick, trace,
            ))

    def set_tick(self, tick: int) -> None:
        """Stamp subsequent spans with the GLOBAL tick number (called
        once per GLOBAL tick)."""
        _affinity.expect("tick-loop")
        self.tick = tick

    # ---- introspection ---------------------------------------------------

    def stats(self) -> dict:
        with self._rings_lock:
            rings = list(self._rings.values())
        return {
            "enabled": self.enabled,
            "rings": len(rings),
            "spans": sum(r.count for r in rings),
            "dropped": sum(r.dropped for r in rings),
            "tick": self.tick,
            "anomalies": len(self.anomalies),
        }

    def snapshot(self, last_ticks: Optional[int] = None) -> list[dict]:
        """Freeze every ring and return span dicts (oldest-first per
        ring), optionally restricted to the last N ticks."""
        with self._rings_lock:
            rings = list(self._rings.values())
        floor = None
        if last_ticks is not None:
            floor = self.tick - last_ticks + 1
        out: list[dict] = []
        for ring in rings:
            for e in ring.snapshot():
                kind, name, lane, start_ns, dur_ns, tick, trace = e
                if floor is not None and tick < floor:
                    continue
                d = {
                    "kind": kind, "name": name, "lane": lane,
                    "start_ns": start_ns, "dur_ns": dur_ns, "tick": tick,
                    "tid": ring.tid,
                }
                if trace is not None:
                    d["trace"] = trace
                out.append(d)
        out.sort(key=lambda d: d["start_ns"])
        return out

    # ---- dumps -----------------------------------------------------------

    def _dump_path(self, trigger: str) -> str:
        """profiles/trace_<trigger>_<stamp>.<seq>_<pid>.json — the seq
        component keeps same-second dumps (sub-second anomaly cooldowns,
        back-to-back SIGUSR2s) from overwriting each other."""
        os.makedirs(self.dump_path, exist_ok=True)
        stamp = time.strftime("%Y%m%d%H%M%S")
        seq = next(_dump_counter)
        return os.path.join(
            self.dump_path,
            f"trace_{trigger}_{stamp}.{seq}_{os.getpid()}.json",
        )

    def to_trace_events(self, spans: list[dict]) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object for ``spans``
        (as returned by :meth:`snapshot`)."""
        pid = os.getpid()
        events = []
        # One timeline row per (thread, lane): channel ticks get their
        # own rows, the default lane groups the rest. Row ids are
        # allocated per dump (first-seen order) — spatial channel ids
        # start at 0x10000, so any arithmetic fold would collide
        # distinct channels onto one row and render false nesting.
        rows: dict[tuple, int] = {}
        for s in spans:
            ts_us = (s["start_ns"] - self._epoch_ns) / 1e3
            ev = {
                "name": s["name"],
                "ph": s["kind"],
                "ts": ts_us,
                "pid": pid,
                "tid": rows.setdefault((s["tid"], s["lane"]), len(rows)),
                "args": {"tick": s["tick"], "lane": s["lane"]},
            }
            if s["kind"] == _COMPLETE:
                ev["dur"] = s["dur_ns"] / 1e3
            else:
                ev["s"] = "t"  # instant scope: thread
            if "trace" in s:
                ev["args"]["trace"] = s["trace"]
            events.append(ev)
        with self._rings_lock:
            # The anomaly path calls this from its off-thread writer; a
            # writer thread registering its first ring mid-iteration
            # must not kill the dump with dict-changed-size.
            dropped = sum(r.dropped for r in self._rings.values())
        meta = {
            "origin": self.origin or f"pid:{pid}",
            "tick": self.tick,
            "dropped": dropped,
        }
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": meta,
        }

    def dump_trace(self, path: Optional[str] = None,
                   last_ticks: Optional[int] = None,
                   trigger: str = "manual") -> str:
        """Write the ring contents as Perfetto JSON; returns the path.
        Counted in ``trace_dumps_total{trigger}`` like the anomaly
        path, so manual/sigusr2/shutdown dumps show on /metrics too."""
        from . import metrics

        metrics.trace_dumps.labels(trigger=trigger).inc()
        doc = self.to_trace_events(self.snapshot(last_ticks))
        doc["otherData"]["trigger"] = trigger
        if path is None:
            path = self._dump_path(trigger)
        with open(path, "w") as f:
            json.dump(doc, f)
        logger.info("flight-recorder trace (%s, %d events) -> %s",
                    trigger, len(doc["traceEvents"]), path)
        return path

    def note_anomaly(self, trigger: str, detail: str = "",
                     force: bool = False) -> Optional[str]:
        """An anomalous tick: count it, and (cooldown permitting) freeze
        the ring and auto-dump the last ``dump_ticks`` ticks. Returns
        the dump path when one was written. A disabled recorder is a
        full no-op — call sites guard on ``recorder.enabled`` and this
        matches them: ``-trace false`` means no anomaly accounting at
        all, not a metric without dumps. ``force`` skips the cooldown
        CHECK (the window still resets): for triggers that are rare by
        construction AND must always ship a timeline — an SLO breach
        (core/slo.py: rising-edge + min-events gated) would otherwise
        lose its dump slot to a storm of per-tick tick_budget anomalies
        on a saturated box. The snapshot is synchronous (a bounded ring
        copy); the JSON write runs on a daemon thread so the tick that
        tripped the anomaly is not stalled by disk I/O."""
        if not self.enabled:
            return None
        from . import metrics

        metrics.trace_dumps.labels(trigger=trigger).inc()
        record = {"trigger": trigger, "detail": detail, "tick": self.tick,
                  "t": time.monotonic()}
        self.anomalies.append(record)
        del self.anomalies[:-256]  # bounded like everything else here
        now = time.monotonic()
        if not force and now - self._last_dump_at < self.anomaly_cooldown_s:
            return None
        self._last_dump_at = now
        # Only the ring freeze (a bounded copy) runs on the tick path;
        # event formatting + JSON + disk all happen off-thread — an
        # anomaly dump must never widen the very tick it is recording.
        spans = self.snapshot(self.dump_ticks)
        path = self._dump_path(trigger)
        record["path"] = path

        def _write():
            _affinity.enter("trace-dumper")
            try:
                doc = self.to_trace_events(spans)
                doc["otherData"]["trigger"] = trigger
                doc["otherData"]["detail"] = detail
                with open(path, "w") as f:
                    json.dump(doc, f)
                logger.warning(
                    "anomaly %s (%s): last %d ticks (%d spans) frozen -> %s",
                    trigger, detail or "-", self.dump_ticks, len(spans), path,
                )
            except OSError as e:  # pragma: no cover - disk trouble
                logger.error("anomaly dump failed: %s", e)

        threading.Thread(target=_write, daemon=True,
                         name=f"trace-dump-{trigger}").start()
        return path


# Cached per-stage histogram children (label resolution is dict work;
# stages are a small fixed set, so resolve each once).
_stage_children: dict = {}


def _stage_ms(stage: str):
    child = _stage_children.get(stage)
    if child is None:
        from . import metrics

        child = metrics.tick_stage_ms.labels(stage=stage)
        _stage_children[stage] = child
    return child


recorder = FlightRecorder()


def configure_from_settings() -> None:
    """Apply the -trace* flags (run_server boot path)."""
    from .settings import global_settings as st

    recorder.configure(
        enabled=st.trace_enabled,
        ring_spans=st.trace_ring_spans,
        dump_ticks=st.trace_dump_ticks,
        dump_path=st.profile_path,
        anomaly_cooldown_s=st.trace_anomaly_cooldown_s,
        origin=st.federation_gateway_id,
    )


def install_trace_dump_signal() -> bool:
    """Bind SIGUSR2 to a manual flight-recorder dump: ``kill -USR2
    <pid>`` freezes the ring and writes the full timeline as Perfetto
    JSON (path logged). Installed at server start; False where SIGUSR2
    does not exist or outside the main thread."""
    import signal

    def _on_sigusr2(signum, frame) -> None:
        recorder.dump_trace(trigger="sigusr2")

    sig = getattr(signal, "SIGUSR2", None)
    if sig is None:
        return False
    try:
        signal.signal(sig, _on_sigusr2)
    except ValueError:
        return False  # not the main thread
    return True


def register_shutdown_dump() -> None:
    """Dump the ring on process exit (run_server boot path only — a
    library embedding must opt in, or every pytest run would write
    profiles/)."""
    import atexit

    def _on_exit() -> None:
        if recorder.enabled and any(
            r.count for r in recorder._rings.values()
        ):
            recorder.dump_trace(trigger="shutdown")

    atexit.register(_on_exit)


def reset_tracing() -> None:
    """Test hook."""
    recorder.reset()
