"""Device supervision & in-process engine recovery (doc/device_recovery.md).

Every resilience plane before this one (chaos, overload, failover,
balancer, federation, global control) assumed the device engine itself
never fails: an XLA error, a hung dispatch, or silently corrupted device
state in ``SpatialEngine.tick()`` would propagate up through
``channel.tick_once`` and take down the whole gateway — stranding its
shard until the fleet's death declaration adopts it. This module makes a
single-chip fault a local, bounded event instead:

- **Watchdog.** The guarded step runs on a dedicated worker thread and
  the tick waits at most ``device_step_deadline_s`` (a device read
  blocks, so hang detection must be off-thread). A timed-out step is
  abandoned: the engine's generation fence is bumped so the zombie
  worker can never commit its tail state over a rebuilt engine, the
  worker pool is discarded, and the failure is FATAL (a wedged chip
  does not get better by retrying into it).

- **Classification.** Step exceptions are transient-vs-fatal:
  transient (allocator pressure — ``torch.OutOfMemoryError`` — and the
  retryable runtime status names) retries with exponential backoff up
  to ``device_retry_max`` attempts while the gateway degrades; anything
  else, an exhausted retry budget, a hang, or a sentinel hit is fatal.
  A sticky CUDA error (an illegal address, a failed launch) poisons the
  process's CUDA context: it is fatal, and when the rebuild fails on it
  too the guard stays FAILED for good instead of retrying — only a
  process restart heals it, and ``/readyz`` reports not ready.

- **Corruption sentinel.** NaN/out-of-range device rot is caught from
  the *already-fetched* batched readback arrays — the handover rows,
  the handover count, the due bitmap — with pure-host range checks. No
  new device->host transfers are added (tpulint's hot-readback rule
  stays clean): a NaN position maps outside the world and a rotted cell
  baseline surfaces as an impossible src cell in a crossing row, which
  is exactly what the checks pin.

- **In-process rebuild.** On a fatal failure the engine is rebuilt from
  the host-side shadow: the entity registry, query params and sub
  intervals are already authoritative on host, and the per-slot cell
  baselines are re-seeded from the grid's ``_data_cell`` placement
  ledger with the failover journal's in-flight dsts outranking it (a
  mid-crossing entity re-baselines to where its data is actually
  bound). The rebuilt arrays are verified bit-identical against the
  shadow before the gateway resumes device service; entities that
  moved during the outage re-detect their crossings from the reseeded
  baseline, so nothing is lost or duplicated.

While the engine is down the gateway *degrades instead of dying*:
``run_step`` returns None, the controller holds device-dependent work
(due fan-out decisions, crossing orchestration, follower passes), the
overload ladder is pinned to L2+ (shedding outranks a dead engine), and
the flight recorder freezes an anomaly dump at the failure tick. A
fatal failure and a completed rebuild each write an immediate snapshot
through the shared fsync'd ``write_snapshot`` path, so a crash during
recovery still boot-restores to the newest state.

Every recovery is counted twice on purpose — the
``device_recoveries_total{cause}`` counter AND the guard's python-side
ledger — so ``scripts/device_soak.py`` proves the accounting exact.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import math
import time
from enum import IntEnum
from typing import Optional

import torch

from ..chaos.injector import chaos as _chaos
from ..utils.logger import get_logger
from .affinity import affinity as _affinity
from .settings import global_settings

logger = get_logger("device_guard")


class DeviceState(IntEnum):
    ACTIVE = 0  # serving
    DEGRADED = 1  # transient step failure; retrying with backoff
    REBUILDING = 2  # fatal failure; in-process rebuild in progress
    FAILED = 3  # the rebuild itself failed; retrying on a backoff


class DeviceStepError(RuntimeError):
    """A device step failure with an explicit transient/fatal tag (used
    by the chaos injection and available to engine wrappers)."""

    def __init__(self, message: str, transient: bool = False):
        super().__init__(message)
        self.transient = transient


class _StepHang(RuntimeError):
    pass


# Substrings of retryable runtime status names. Everything NOT matching
# (and not an allocator OOM) is treated as fatal — when in doubt,
# rebuild (a wrong "transient" guess burns the whole retry budget inside
# a corrupted engine).
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "ABORTED",
    "DEADLINE_EXCEEDED",
)

# CUDA's sticky errors, as their messages read: once one is raised,
# every later call in the process's CUDA context fails the same way, so
# an in-process rebuild cannot heal it.
_STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "device-side assert",
    "uncorrectable ECC error",
    "hardware stack error",
)


def classify_failure(exc: BaseException) -> str:
    """'transient' or 'fatal' for one device-step exception."""
    if isinstance(exc, DeviceStepError):
        return "transient" if exc.transient else "fatal"
    if isinstance(exc, torch.OutOfMemoryError):
        return "transient"
    if is_sticky_cuda_error(exc):
        return "fatal"
    text = str(exc)
    if any(marker in text for marker in _TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` reports a CUDA error that poisons the context."""
    text = str(exc)
    return any(marker in text for marker in _STICKY_CUDA_MARKERS)


def _on_device(device: torch.device):
    """The engine's CUDA device as the worker thread's current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class DeviceGuard:
    """Process-wide device supervision state machine (one instance:
    ``guard``). The GPU spatial controller routes its per-tick engine
    step through :meth:`run_step`; everything else reads state."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.state = DeviceState.ACTIVE
        # Python-side recovery ledger; must match
        # device_recoveries_total exactly (the soak cross-checks).
        self.recovery_counts: dict[str, int] = {}
        self.failure_counts: dict[str, int] = {}
        self.events: list[dict] = []
        self.held_ticks = 0
        self.recovery_times_s: list[float] = []
        self._retry_count = 0
        self._not_before = 0.0
        self._rebuild_attempts = 0
        self._rebuild_fut: Optional[concurrent.futures.Future] = None
        self._rebuild_t0 = 0.0
        self._failed_at: Optional[float] = None
        self._fatal_cause = ""
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._started = time.monotonic()
        self._publish_state()

    # ---- plumbing --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return global_settings.device_guard_enabled

    @property
    def terminal(self) -> bool:
        """FAILED for good: a sticky CUDA error poisoned the context, and
        only a new process serves again (no rebuild is ever retried)."""
        return self.state == DeviceState.FAILED and math.isinf(self._not_before)

    def _publish_state(self) -> None:
        try:  # lazy: metrics must not be a module-load dependency
            from . import metrics

            metrics.device_state.set(int(self.state))
        except Exception:
            pass

    def _set_state(self, state: DeviceState) -> None:
        if state == self.state:
            return
        old = self.state
        self.state = state
        self.events.append({
            "t": round(time.monotonic() - self._started, 3),
            "from": old.name,
            "to": state.name,
        })
        log = logger.info if state == DeviceState.ACTIVE else logger.warning
        log("device state %s -> %s", old.name, state.name)
        self._publish_state()

    def _count_recovery(self, cause: str) -> None:
        """Double-entry recovery accounting: python ledger AND the
        prometheus counter move together, always."""
        self.recovery_counts[cause] = self.recovery_counts.get(cause, 0) + 1
        from . import metrics

        metrics.device_recoveries.labels(cause=cause).inc()

    def _count_failure(self, cause: str) -> None:
        self.failure_counts[cause] = self.failure_counts.get(cause, 0) + 1
        from . import metrics

        metrics.device_step_failures.labels(cause=cause).inc()

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="device-step"
            )
        return self._pool

    def _abandon_executor(self) -> None:
        """Give up on a hung worker: the pool (and its stuck thread) is
        discarded without waiting; the next step gets a fresh one."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def shutdown(self) -> None:
        """Test/teardown hook: release the worker thread."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    # ---- the guarded step ------------------------------------------------

    def run_step(self, controller) -> Optional[dict]:
        """Run one supervised engine step for ``controller``
        (GPUSpatialController). Returns the step result with the batched
        readback arrays already materialized on host — or None while the
        engine is down/held (the controller must hold all
        device-dependent work for that tick)."""
        # Affinity: the guard's state machine is loop-thread-only; all
        # device waits happen on the worker via _dispatch.
        _affinity.expect("tick-loop")
        now = time.monotonic()
        if self.state != DeviceState.ACTIVE:
            if now < self._not_before:
                self.held_ticks += 1
                return None
            if self.state in (DeviceState.REBUILDING, DeviceState.FAILED):
                self._attempt_rebuild(controller)
                self.held_ticks += 1
                return None  # serve again from the NEXT tick
            # DEGRADED: backoff elapsed — retry the step below.
        if _chaos.armed and _chaos.fire("device.nan"):
            # Chaos: silent device-state rot (NaN positions + garbage
            # cell baselines). Planted BEFORE the step so the sentinel
            # must catch it from the ordinary readback, exactly like a
            # real bit-flip would have to be caught.
            controller.engine.corrupt_device_state_for_chaos()
        try:
            result = self._dispatch(controller.engine)
        except _StepHang:
            self._count_failure("hang")
            logger.error(
                "device step exceeded the %.2fs watchdog deadline; "
                "abandoning the worker and rebuilding",
                global_settings.device_step_deadline_s,
            )
            self._enter_fatal(controller, "hang")
            return None
        except Exception as exc:
            self._count_failure("step_error")
            if (
                classify_failure(exc) == "transient"
                and self._retry_count < global_settings.device_retry_max
            ):
                self._retry_count += 1
                backoff = (
                    global_settings.device_retry_backoff_ms / 1000.0
                ) * (2 ** (self._retry_count - 1))
                self._not_before = time.monotonic() + backoff
                if self._failed_at is None:
                    self._failed_at = now
                logger.warning(
                    "transient device step failure (%r); retry %d/%d "
                    "in %.0fms", exc, self._retry_count,
                    global_settings.device_retry_max, backoff * 1000.0,
                )
                self._set_state(DeviceState.DEGRADED)
                self._pin_ladder()
                return None
            self._enter_fatal(controller, "step_error")
            return None
        corrupt = self._sentinel(controller.engine, result)
        if corrupt:
            self._count_failure("corruption")
            logger.error("device readback sentinel: %s; rebuilding",
                         corrupt)
            self._enter_fatal(controller, "corruption")
            return None
        if self.state == DeviceState.DEGRADED:
            # A retried step came back clean: transient recovery,
            # no rebuild needed.
            self._finish_recovery("transient")
        self._retry_count = 0
        return result

    def _dispatch(self, engine) -> dict:
        gen = engine.generation
        fut = self._executor().submit(self._step_body, engine, gen)
        try:
            return fut.result(
                timeout=max(global_settings.device_step_deadline_s, 0.001)
            )
        except concurrent.futures.TimeoutError:
            # Fence first, then abandon: the zombie re-checks the
            # generation before touching the engine and before
            # committing its tail state (ops/engine.py tick()).
            engine.bump_generation()
            self._abandon_executor()
            fut.add_done_callback(_log_zombie)
            raise _StepHang()

    @staticmethod
    def _step_body(engine, gen: int) -> dict:
        """Worker-thread body: chaos gates, the engine step, and the
        batched readback fetch — ALL device waits happen here so the
        watchdog deadline covers dispatch and transfer alike. The tick
        runs with the engine's device current on this thread."""
        _affinity.enter("device-worker")
        if _chaos.armed:
            stall = _chaos.stall_s("device.step_hang")
            if stall:
                # Models a wedged dispatch: the blocking sleep stands in
                # for a device call that never completes within deadline.
                time.sleep(stall)
            if _chaos.fire("device.step_error"):
                raise DeviceStepError(
                    "chaos: injected device step error "
                    "(RESOURCE_EXHAUSTED)", transient=True,
                )
        if gen != engine.generation:
            # This step was abandoned while the chaos stall (or a real
            # queue wait) held the worker: never touch the engine.
            raise RuntimeError("stale device tick abandoned by watchdog")
        with _on_device(engine.device):
            result = engine.tick()
            # The per-tick batched readbacks, fetched ONCE inside the
            # guarded window (a hung transfer is a hang, not a mystery
            # stall in the controller) and handed on as numpy so the
            # controller's handover_list/_publish_due add no new
            # transfers: the consume blob (one transfer, parsed and
            # cached on the result by the engine; a cells-plane mesh
            # tick's blob also carries the overflow count and the
            # undelivered slots the controller's shed reads) ...
            count, rows, _, due = engine.consume(result)
            result["handover_count"] = count
            result["handovers"] = rows
            result["due"] = due
            if result.get("query_blob") is not None:
                # ... the standing-query plane's ONE changed-rows
                # transfer (cached on the result as numpy) ...
                engine.query_changed_rows(result)
            if result.get("sim_census") is not None:
                # ... and, on census ticks only, the sim plane's four
                # kinematic columns.
                result["sim_census"] = tuple(
                    # tpulint: disable=hot-readback -- the sim plane's census-cadence batched fetch (its ONLY readback, doc/simulation.md), pre-fetched inside the guarded window
                    a.cpu().numpy() for a in result["sim_census"]
                )
        return result

    # ---- corruption sentinel ---------------------------------------------

    @staticmethod
    def _sentinel(engine, result: dict) -> Optional[str]:
        """Range/shape checks over the already-fetched readback arrays;
        returns a description of the rot, or None when clean. All
        device readbacks in this engine are integer/bool arrays, so
        float NaN/inf rot cannot surface literally — it surfaces as
        impossible values (a NaN position assigns outside the world; a
        rotted baseline produces a crossing from a cell that does not
        exist), which is exactly what is pinned here."""
        count = result["handover_count"]
        rows = result["handovers"]
        if count < 0 or count > engine.entity_capacity:
            return f"handover count {count} outside [0, capacity]"
        n_cells = engine.grid.num_cells
        head = rows[: min(count, len(rows))]
        if len(head):
            slots = head[:, 0]
            cells = head[:, 1:]
            if int(slots.max(initial=0)) >= engine.entity_capacity:
                return "handover row slot beyond entity capacity"
            bad = (cells < 0) | (cells >= n_cells)
            # The compaction's discard lane can leave slot == -1 rows;
            # only rows naming a real slot must carry real cells.
            if bool((bad & (slots >= 0)[:, None]).any()):
                return (
                    "handover row cites an impossible cell "
                    f"(grid has {n_cells})"
                )
        due = result["due"]
        if len(due) != engine.sub_capacity:
            return "due bitmap length mismatch"
        q_blob = result.get("query_blob")
        if q_blob is not None:
            q_count = int(q_blob[0])  # tpulint: disable=hot-readback -- q_blob was pre-fetched as host numpy in _step_body; this indexes host memory, not the device
            q_cap = engine.query_capacity * n_cells
            if q_count < 0 or q_count > q_cap:
                return f"query change count {q_count} outside [0, Q*C]"
            q_rows = q_blob[1:].reshape(-1, 3)
            head = q_rows[: min(q_count, len(q_rows))]
            if len(head):
                live = head[:, 0] >= 0
                if int(head[:, 0].max(initial=0)) >= engine.query_capacity:
                    return "query change row beyond query capacity"
                bad_cell = (head[:, 1] < 0) | (head[:, 1] >= n_cells)
                if bool((bad_cell & live).any()):
                    return (
                        "query change row cites an impossible cell "
                        f"(grid has {n_cells})"
                    )
        return None

    # ---- failure / recovery ----------------------------------------------

    def _pin_ladder(self) -> None:
        from .overload import governor

        governor.pin_floor(2, "device engine down")

    def _release_ladder(self) -> None:
        from .overload import governor

        governor.release_floor()

    def _enter_fatal(self, controller, cause: str) -> None:
        if self._failed_at is None:
            self._failed_at = time.monotonic()
        self._fatal_cause = cause
        self._rebuild_attempts = 0
        self._retry_count = 0
        self._set_state(DeviceState.REBUILDING)
        self._pin_ladder()
        from .tracing import recorder as _trace

        if _trace.enabled:
            # Freeze the timeline at the failure tick: the dump holds
            # the stages that led into the fault.
            _trace.note_anomaly(
                "device_failure", f"{cause}: engine down, rebuilding"
            )
        controller.on_device_fatal(cause)
        # Crash-during-recovery durability: snapshot NOW, before the
        # rebuild runs, through the shared fsync'd path — written
        # SYNCHRONOUSLY: a loop task would not get a turn until after
        # _attempt_rebuild releases the loop thread, which is exactly
        # too late for the crash-during-rebuild case this write exists
        # for (the tick is already stalled for the rebuild anyway).
        self._snapshot("device_fatal", sync=True)
        self._attempt_rebuild(controller)

    def _attempt_rebuild(self, controller) -> None:
        """Drive the in-process rebuild WITHOUT parking the event loop:
        the rebuild's device calls (device_put, the verification
        readbacks) run on the SAME deadline-guarded worker as the step —
        against a genuinely wedged device a synchronous rebuild would
        block the loop thread for seconds: no ticks, no trunk
        heartbeats (a federated peer would declare this gateway DEAD
        over a fault it is actively recovering from), no SIGTERM drain.
        Instead the wait per tick is bounded at min(step deadline, 1s):
        the common millisecond rebuild completes inside it
        (synchronous semantics), a slow one degrades to per-tick
        polling, and one wedged past 4x the step deadline is abandoned
        into FAILED (backoff retry) behind the same generation fence as
        a hung step."""
        from . import metrics

        engine = controller.engine
        if self._rebuild_fut is None:
            self._set_state(DeviceState.REBUILDING)
            try:
                if _chaos.armed and _chaos.fire("device.rebuild_fail"):
                    raise RuntimeError("chaos: injected rebuild failure")
                seeds = controller.rebuild_seed_cells()
                # The tables the rebuild uploads, copied here on the loop
                # thread: a rebuild polled across ticks runs on while
                # this thread goes on writing them.
                shadow = engine.host_shadow()
            except Exception as exc:
                self._rebuild_failed(exc)
                return
            self._rebuild_t0 = time.monotonic()
            self._rebuild_fut = self._executor().submit(
                self._rebuild_body, engine, seeds, engine.generation, shadow
            )
        fut = self._rebuild_fut
        try:
            mismatches = fut.result(timeout=min(
                max(global_settings.device_step_deadline_s, 0.001), 1.0
            ))
        except concurrent.futures.TimeoutError:
            deadline = max(global_settings.device_step_deadline_s * 4, 0.004)
            if time.monotonic() - self._rebuild_t0 >= deadline:
                self._rebuild_fut = None
                engine.bump_generation()
                self._abandon_executor()
                fut.add_done_callback(_log_zombie)
                self._rebuild_failed(RuntimeError(
                    "rebuild exceeded the watchdog deadline (device "
                    "still wedged)"
                ))
            return  # still rebuilding: poll again next tick
        except Exception as exc:
            self._rebuild_fut = None
            self._rebuild_failed(exc)
            return
        self._rebuild_fut = None
        if mismatches:
            self._rebuild_failed(RuntimeError(
                f"rebuild verification failed: {mismatches}"
            ))
            return
        took_ms = (time.monotonic() - self._rebuild_t0) * 1000.0
        metrics.device_rebuild_ms.observe(took_ms)
        logger.warning(
            "engine rebuilt in-process from the host shadow: %d entities "
            "re-seeded, verified bit-identical (%.1fms)",
            engine.entity_count(), took_ms,
        )
        self._finish_recovery(self._fatal_cause)
        # Recovery durability: the rebuilt state is the newest truth.
        self._snapshot("device_recovered")

    def _rebuild_failed(self, exc: BaseException) -> None:
        self._count_failure("rebuild_fail")
        if is_sticky_cuda_error(exc):
            # Terminal: the context is poisoned, so every retry would
            # fail the same way. Hold FAILED for good (never retry);
            # /readyz reports not ready so the process is restarted.
            self._not_before = math.inf
            logger.error(
                "in-process engine rebuild failed on a sticky CUDA error "
                "(%r): the CUDA context is poisoned; device service stays "
                "down until the process restarts", exc,
            )
            self._set_state(DeviceState.FAILED)
            return
        self._rebuild_attempts += 1
        backoff = (
            global_settings.device_retry_backoff_ms / 1000.0
        ) * (2 ** min(self._rebuild_attempts, 6))
        self._not_before = time.monotonic() + backoff
        logger.error(
            "in-process engine rebuild failed (attempt %d: %r); "
            "retrying in %.0fms", self._rebuild_attempts, exc,
            backoff * 1000.0,
        )
        self._set_state(DeviceState.FAILED)

    @staticmethod
    def _rebuild_body(engine, seeds: dict, gen: int, shadow: Optional[dict] = None):
        """Worker-thread rebuild: re-seed from the host shadow (``shadow``,
        copied on the loop thread), then the bit-identical verification
        readbacks. Two fences keep an
        abandoned (timed-out) rebuild from ever clobbering a later
        successful one when the device unwedges: the engine's rebuild
        lock serializes concurrent rebuild bodies outright, and
        ``expect_generation`` inside rebuild_device_state refuses to
        commit once the watchdog bumped the generation — the stale
        worker raises AFTER its blocking transfers, BEFORE any
        engine-visible mutation."""
        _affinity.enter("device-worker")
        if not engine._rebuild_lock.acquire(
            timeout=max(global_settings.device_step_deadline_s * 4, 0.004)
        ):
            raise RuntimeError(
                "rebuild lock held by an abandoned rebuild (device "
                "still wedged)"
            )
        try:
            if gen != engine.generation:
                raise RuntimeError("stale rebuild abandoned by watchdog")
            with _on_device(engine.device):
                engine.rebuild_device_state(seeds, expect_generation=gen, shadow=shadow)
                return engine.verify_device_state(seeds)
        finally:
            engine._rebuild_lock.release()

    def _finish_recovery(self, cause: str) -> None:
        recovery_s = (
            time.monotonic() - self._failed_at
            if self._failed_at is not None else 0.0
        )
        self.recovery_times_s.append(recovery_s)
        deadline = global_settings.device_recovery_deadline_s
        if recovery_s > deadline:
            logger.warning(
                "device recovery took %.2fs (deadline %.2fs)",
                recovery_s, deadline,
            )
        self._count_recovery(cause)
        self.events.append({
            "t": round(time.monotonic() - self._started, 3),
            "recovered": cause,
            "recovery_s": round(recovery_s, 3),
        })
        self._failed_at = None
        self._fatal_cause = ""
        self._retry_count = 0
        self._not_before = 0.0
        self._set_state(DeviceState.ACTIVE)
        self._release_ladder()

    def _snapshot(self, reason: str, sync: bool = False) -> None:
        """Immediate snapshot through the shared fsync'd write path
        (core/snapshot.py). ``sync`` writes inline (the fatal-entry
        snapshot: it must be durable BEFORE the rebuild stalls the loop
        thread); otherwise the disk IO runs off-thread when an event
        loop is up so the tick never stalls on fsync."""
        path = global_settings.snapshot_path
        if not path:
            return
        try:
            from .snapshot import take_snapshot, write_snapshot

            snap = take_snapshot()
            import asyncio

            if sync:
                write_snapshot(snap, path)
                logger.info("snapshot written on %s (%d channels)",
                            reason, len(snap.channels))
                return
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                write_snapshot(snap, path)
            else:
                task = loop.create_task(
                    asyncio.to_thread(write_snapshot, snap, path)
                )
                task.add_done_callback(_log_snapshot_error)
            logger.info("snapshot scheduled on %s (%d channels)",
                        reason, len(snap.channels))
        except Exception:
            logger.exception("%s snapshot failed", reason)

    # ---- reporting -------------------------------------------------------

    def report(self) -> dict:
        return {
            "state": self.state.name,
            "recovery_counts": dict(self.recovery_counts),
            "failure_counts": dict(self.failure_counts),
            "recovery_times_s": [round(s, 3) for s in self.recovery_times_s],
            "held_ticks": self.held_ticks,
            "events": list(self.events),
        }


def _log_snapshot_error(task) -> None:
    """Off-thread snapshot writes must never surface as unretrieved
    task exceptions (e.g. the target dir vanished under a test
    teardown); the failure is logged, the gateway unaffected."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.warning("device-recovery snapshot write failed: %r", exc)


def _log_zombie(fut) -> None:
    exc = fut.exception()
    if exc is not None:
        logger.info("abandoned device step finished with %r", exc)
    else:
        logger.info("abandoned device step finished late (discarded)")


# The process-wide guard. The GPU controller holds a module reference;
# a disabled guard costs one attribute load per tick.
guard = DeviceGuard()


def reset_device_guard() -> None:
    """Test hook."""
    guard.shutdown()
    guard.reset()
