"""Overload governor: gateway-wide adaptive degradation ladder.

The reference gateway targets 10K connections and 100K msg/s on one
node; at the edges of that envelope the r5 measurements showed it
*collapses rather than degrades* — the ingest floor saturates, the
batched handover path eats the tick budget, and nothing sheds load on
purpose. This module is the complementary half of the chaos plane
(channeld_tpu/chaos): graceful, observable, *reversible* degradation
under sustained overload, in the load-shedding/brownout tradition of
the overload-management literature (PAPERS.md: the WeChat overload-
control line and SEDA's adaptive admission control).

Design:

- Subsystems feed cheap per-tick cost signals into the process-wide
  ``governor`` (tick duration vs budget from ``core/channel.py``,
  handover-batch and follower-interest host cost from
  ``spatial/tpu_controller.py``); the governor itself samples ingest
  backlog depth and stash occupancy from ``core/connection.py`` /
  ``core/channel.py`` once per GLOBAL tick.
- Each signal normalizes to "1.0 == saturated"; the raw pressure is the
  worst component (weakest-link semantics) and is EWMA-smoothed so a
  single slow tick cannot flap the ladder.
- A four-level ladder moves at most ONE step per update, up only after
  ``up_hold`` consecutive over-threshold samples, down only after the
  smoothed pressure stayed under the exit threshold for
  ``down_hold_s`` (hysteresis — enter and exit thresholds are
  deliberately apart):

  * **L0** normal service.
  * **L1** brownout: per-subscriber fan-out intervals stretch by
    ``l1_stretch`` and ChannelData updates coalesce harder (the update
    ring accumulates; nothing is lost, delivery cadence drops).
  * **L2** shed: fan-out stretches by ``l2_stretch``; lowest-priority
    channel updates (priority derived from subscription options) are
    withheld; non-owner handover fan-out is deferred and handover
    orchestration is capped per tick (the tail re-offers next tick).
  * **L3** admission control: new client connections and new client
    subscriptions are refused with a structured
    ``ServerBusyMessage(retryAfterMs)`` instead of letting the reactor
    floor drown every existing session.

- Every shed/deferral/refusal is counted twice on purpose: in the
  ``overload_sheds_total{reason}`` prometheus counter AND in the
  governor's own python-side ledger — the soak's invariant checker
  cross-checks the two, so the accounting is provably exact.

All hooks are attribute-load cheap at L0; the ladder only costs
anything while the gateway is actually melting.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

from .settings import global_settings
from ..utils.logger import get_logger

logger = get_logger("overload")


class OverloadLevel(IntEnum):
    L0 = 0  # normal
    L1 = 1  # brownout: stretch fan-out, coalesce harder
    L2 = 2  # shed: low-priority updates + handover fan-out deferral
    L3 = 3  # admission control: refuse new conns/subs with retry-after


@dataclass
class AdmissionDecision:
    """The structured result of an admission check. ``retry_after_ms``
    rides to the peer in a ServerBusyMessage when ``admitted`` is
    False."""

    admitted: bool
    retry_after_ms: int = 0
    reason: str = ""


class OverloadGovernor:
    """Process-wide overload state machine (one instance: ``governor``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.level: int = OverloadLevel.L0
        self.pressure: float = 0.0  # smoothed
        self.components: dict[str, float] = {}
        # Transition history for soak artifacts / monotonicity checks.
        self.transitions: list[dict] = []
        # Python-side shed ledger; must match overload_sheds_total.
        self.shed_counts: dict[str, int] = {}
        self._worst_util = 0.0
        self._handover_cost_s = 0.0
        self._follower_cost_s = 0.0
        # Per-server pressure export (consumed by the spatial load
        # balancer, spatial/balancer.py): owner conn id -> EWMA of the
        # tick cost of the spatial channels that server owns, as a
        # fraction of the GLOBAL tick budget. The gateway-wide ladder
        # stays the weakest-link signal; this is the attribution the
        # balancer needs to tell a hot SERVER from a hot gateway.
        self.server_pressure: dict[int, float] = {}
        self._server_cost_s: dict[int, float] = {}
        self._up_ticks = 0
        self._down_since: Optional[float] = None
        self._last_down_at = -1e9  # anti-flap cooldown anchor
        # Emergency level floor (core/device_guard.py): while the device
        # engine is down the ladder is pinned at/above this level —
        # shedding outranks a dead engine (doc/device_recovery.md).
        self._level_floor = 0
        self._floor_reason = ""
        self._started = time.monotonic()
        self._publish_level()

    # ---- signal intake (hot paths; keep them cheap) ----------------------

    def note_tick(self, elapsed_s: float, interval_s: float) -> None:
        """One channel tick's budget utilization; the governor keeps the
        worst since its last update (any saturated channel type counts)."""
        if interval_s > 0:
            util = elapsed_s / interval_s
            if util > self._worst_util:
                self._worst_util = util

    def note_handover_cost(self, seconds: float) -> None:
        self._handover_cost_s += seconds

    def note_follower_cost(self, seconds: float) -> None:
        self._follower_cost_s += seconds

    def note_server_cost(self, owner_conn_id: int, seconds: float) -> None:
        """One owned spatial channel's tick cost, attributed to its
        owner server (fed from Channel.tick_once)."""
        acc = self._server_cost_s
        acc[owner_conn_id] = acc.get(owner_conn_id, 0.0) + seconds

    def server_pressure_of(self, conn_id: int) -> float:
        return self.server_pressure.get(conn_id, 0.0)

    def _fold_server_pressure(self, interval: float, alpha: float) -> None:
        """EWMA the per-server cost accumulators (always runs, even with
        the ladder disabled — the balancer reads this attribution
        whether or not degradation is armed). Idle servers decay toward
        zero and are dropped once negligible."""
        cost = self._server_cost_s
        pressure = self.server_pressure
        for cid in list(pressure):
            raw = cost.pop(cid, 0.0) / interval
            nxt = alpha * raw + (1.0 - alpha) * pressure[cid]
            if nxt < 1e-4:
                del pressure[cid]
            else:
                pressure[cid] = nxt
        for cid, s in cost.items():
            pressure[cid] = alpha * (s / interval)
        cost.clear()

    # ---- emergency level floor (device guard) ----------------------------

    def pin_floor(self, level: int, reason: str) -> None:
        """Pin the ladder at/above ``level`` until released. Unlike the
        normal one-step-per-tick discipline this jumps immediately — a
        dead device engine IS an emergency, and shedding outranks it
        (doc/device_recovery.md). A no-op while the governor is
        disabled (the operator pinned L0 on purpose)."""
        self._level_floor = int(level)
        self._floor_reason = reason
        if (global_settings.overload_enabled
                and self.level < self._level_floor):
            self._move(self._level_floor, forced=True)

    def release_floor(self) -> None:
        """Drop the emergency floor; the ladder de-escalates through the
        normal hysteresis (down-hold, one step per tick) so the release
        itself cannot flap service levels."""
        self._level_floor = 0
        self._floor_reason = ""

    # ---- the update (once per GLOBAL tick) -------------------------------

    def update(self, interval_s: float) -> None:
        st0 = global_settings
        self._fold_server_pressure(
            interval_s if interval_s > 0 else 0.010, st0.overload_alpha
        )
        if not st0.overload_enabled:
            if self.level:
                self._move(OverloadLevel.L0, forced=True)
            return
        # Ingest backlog depth + stash occupancy, sampled from the
        # connection/channel planes (lazy imports: those modules import
        # settings, not us, so there is no cycle at module load).
        from . import channel as channel_mod
        from . import connection as connection_mod
        from . import edge as edge_mod

        st = global_settings
        stash_conns = len(connection_mod._stash_retry)
        stash_msgs = sum(
            len(c._pending_msgs) for c in connection_mod._stash_retry
        )
        congested = len(channel_mod._congested_channels)
        interval = interval_s if interval_s > 0 else 0.010

        comps = {
            # Worst tick-budget utilization since the last update.
            "tick_util": self._worst_util,
            # Connections parked on full channel queues; any congested
            # channel is a full 4096-deep queue, which IS saturation.
            "backlog": max(
                stash_conns / max(st.overload_backlog_norm, 1),
                min(congested, 4) * 0.5,
            ),
            # Host cost of the batched handover orchestration, as a
            # fraction of the GLOBAL tick budget.
            "handover": self._handover_cost_s / interval,
            # Host cost of applying follower interests, same scale.
            "follower": self._follower_cost_s / interval,
            # Edge-plane distress population (slow-consumer suspects +
            # quarantined peers): each peer is handled per-peer by
            # core/edge.py, but a FLEET of them is gateway saturation
            # and must move the global ladder too.
            "edge": edge_mod.pressure(),
        }
        self.components = comps
        self.components["stash_msgs"] = float(stash_msgs)
        self._worst_util = 0.0
        self._handover_cost_s = 0.0
        self._follower_cost_s = 0.0

        raw = max(comps["tick_util"], comps["backlog"],
                  comps["handover"], comps["follower"], comps["edge"])
        alpha = st.overload_alpha
        self.pressure = alpha * raw + (1.0 - alpha) * self.pressure

        self._step_ladder(st)
        from . import metrics

        metrics.overload_pressure.set(self.pressure)

    def _step_ladder(self, st) -> None:
        enter = st.overload_enter_thresholds
        exit_ = st.overload_exit_thresholds
        level = self.level
        now = time.monotonic()
        if level < OverloadLevel.L3 and self.pressure >= enter[level]:
            self._down_since = None
            # Anti-flap: stepping down releases withheld work (resumed
            # fan-outs, the deferred-handover drain) whose own cost can
            # briefly re-spike the pressure — absorb that transient
            # instead of bouncing straight back up. Sustained overload
            # still re-escalates once the cooldown elapses.
            if now - self._last_down_at < st.overload_up_cooldown_s:
                self._up_ticks = 0
                return
            self._up_ticks += 1
            if self._up_ticks >= st.overload_up_hold_ticks:
                self._up_ticks = 0
                self._move(level + 1)
        elif level > OverloadLevel.L0 and self.pressure < exit_[level - 1]:
            self._up_ticks = 0
            if level - 1 < self._level_floor:
                # Emergency floor (device engine down): hold here no
                # matter how calm the pressure looks — the calm is the
                # held device work, not spare capacity.
                self._down_since = None
                return
            if self._down_since is None:
                self._down_since = now
            elif now - self._down_since >= st.overload_down_hold_s:
                self._down_since = None
                self._last_down_at = now
                self._move(level - 1)
        else:
            self._up_ticks = 0
            self._down_since = None

    def _move(self, new_level: int, forced: bool = False) -> None:
        old = self.level
        self.level = int(new_level)
        self.transitions.append({
            "t": round(time.monotonic() - self._started, 3),
            "from": int(old),
            "to": int(new_level),
            "pressure": round(self.pressure, 4),
        })
        log = logger.warning if new_level > old else logger.info
        log(
            "overload level L%d -> L%d (pressure=%.3f%s)",
            old, new_level, self.pressure, ", forced" if forced else "",
        )
        self._publish_level()
        from .tracing import recorder as _trace

        if _trace.enabled:
            # A ladder move means the gateway changed service level —
            # freeze the timeline that drove it (cooldown-bounded; the
            # dump's last ticks show WHICH stage pushed the pressure).
            _trace.note_anomaly(
                "overload_transition",
                f"L{int(old)}->L{int(new_level)} "
                f"pressure={self.pressure:.3f}",
            )

    def _publish_level(self) -> None:
        try:  # metrics import is lazy so this module stays cycle-free
            from . import metrics

            metrics.overload_level.set(int(self.level))
        except Exception:
            pass

    # ---- degradation queries (hot paths) ---------------------------------

    def fanout_stretch(self) -> float:
        """Multiplier applied to per-subscriber fan-out intervals."""
        if self.level == OverloadLevel.L1:
            return global_settings.overload_l1_stretch
        if self.level >= OverloadLevel.L2:
            return global_settings.overload_l2_stretch
        return 1.0

    def shed_priority_floor(self) -> Optional[int]:
        """Subscriptions with priority >= the floor have their channel
        updates withheld; None = nothing is shed. Priority 0 (WRITE
        access — authority/server subs) is never shed."""
        if self.level == OverloadLevel.L2:
            return 2
        if self.level >= OverloadLevel.L3:
            return 1
        return None

    def defer_handover_fanout(self) -> bool:
        """L2+: only the new owner receives handover fan-out; observers
        are deferred to the normal ChannelData cadence."""
        return self.level >= OverloadLevel.L2

    def handover_batch_cap(self) -> Optional[int]:
        """L2+: crossings orchestrated per tick; the tail re-offers next
        tick (lossless deferral). None = uncapped."""
        if self.level >= OverloadLevel.L2:
            return global_settings.overload_handover_batch_cap
        return None

    def admit_connection(self) -> AdmissionDecision:
        if self.level >= OverloadLevel.L3:
            return AdmissionDecision(
                False, global_settings.overload_retry_after_ms, "connection"
            )
        return AdmissionDecision(True)

    def admit_subscription(self) -> AdmissionDecision:
        if self.level >= OverloadLevel.L3:
            return AdmissionDecision(
                False, global_settings.overload_retry_after_ms, "subscription"
            )
        return AdmissionDecision(True)

    def admit_federation_handover(self) -> AdmissionDecision:
        """L3: refuse an inbound cross-gateway handover batch — the same
        ServerBusyMessage semantics a refused client gets ride back over
        the trunk, and the initiating gateway aborts the batch back to
        its own src cell (doc/federation.md). Refused at L3 only: at L2
        the gateway is shedding *optional* work, but an inbound handover
        is authoritative state whose deferral the initiator would have
        to journal anyway — refusing earlier just moves the retry churn
        to the busier moment."""
        if self.level >= OverloadLevel.L3:
            return AdmissionDecision(
                False, global_settings.overload_retry_after_ms, "federation"
            )
        return AdmissionDecision(True)

    # ---- shed accounting -------------------------------------------------

    def count_shed(self, reason: str, n: int = 1) -> None:
        """Count a shed in BOTH ledgers (prometheus + python); the soak's
        invariant checker asserts the two agree exactly."""
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + n
        from . import metrics

        metrics.overload_sheds.labels(reason=reason).inc(n)

    # ---- reporting -------------------------------------------------------

    def report(self) -> dict:
        return {
            "level": int(self.level),
            "pressure": round(self.pressure, 4),
            "components": {
                k: round(v, 4) for k, v in self.components.items()
            },
            "transitions": list(self.transitions),
            "shed_counts": dict(self.shed_counts),
        }


# The process-wide governor. Hook sites hold a module reference and check
# ``governor.level`` inline; one attribute load while the gateway is
# healthy.
governor = OverloadGovernor()


def sub_priority(options, default_fanout_interval_ms: int) -> int:
    """Subscription priority from its options (lower = more important):
    0 WRITE access (authority/server planes — never shed), 1 READ at or
    under the channel's default cadence, 2 READ slower than the default
    (background observers — first to brown out)."""
    from .types import ChannelDataAccess

    if options.dataAccess == ChannelDataAccess.WRITE_ACCESS:
        return 0
    if options.fanOutIntervalMs <= default_fanout_interval_ms:
        return 1
    return 2


def reset_overload() -> None:
    """Test hook."""
    governor.reset()
