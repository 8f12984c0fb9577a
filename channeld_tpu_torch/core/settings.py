"""Global settings and CLI flag surface.

Capability parity with the reference settings system
(ref: pkg/channeld/settings.go:16-235): the same ~25 flags, the same
channel-settings JSON schema (keyed by numeric ChannelType), and the
same defaults, so reference config files drop in unchanged.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field, replace
from typing import Optional

from .types import ChannelAccessLevel, ChannelType, CompressionType


@dataclass
class ACLSettings:
    sub: ChannelAccessLevel = ChannelAccessLevel.NONE
    unsub: ChannelAccessLevel = ChannelAccessLevel.NONE
    remove: ChannelAccessLevel = ChannelAccessLevel.NONE

    @classmethod
    def from_dict(cls, d: dict) -> "ACLSettings":
        return cls(
            sub=ChannelAccessLevel(d.get("Sub", 0)),
            unsub=ChannelAccessLevel(d.get("Unsub", 0)),
            remove=ChannelAccessLevel(d.get("Remove", 0)),
        )


@dataclass
class ChannelSettings:
    """(ref: settings.go:64-74 ``ChannelSettingsType``)."""

    tick_interval_ms: int = 10
    default_fanout_interval_ms: int = 20
    default_fanout_delay_ms: int = 0
    remove_channel_after_owner_removed: bool = False
    send_owner_lost_and_recovered: bool = False
    acl: ACLSettings = field(default_factory=ACLSettings)
    data_msg_full_name: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "ChannelSettings":
        return cls(
            tick_interval_ms=d.get("TickIntervalMs", 10),
            default_fanout_interval_ms=d.get("DefaultFanOutIntervalMs", 20),
            default_fanout_delay_ms=d.get("DefaultFanOutDelayMs", 0),
            remove_channel_after_owner_removed=d.get(
                "RemoveChannelAfterOwnerRemoved", False
            ),
            send_owner_lost_and_recovered=d.get("SendOwnerLostAndRecovered", False),
            acl=ACLSettings.from_dict(d.get("ACLSettings", {})),
            data_msg_full_name=d.get("DataMsgFullName", ""),
        )


@dataclass
class GlobalSettings:
    """(ref: settings.go:16-56 ``GlobalSettingsType`` + defaults :76-105)."""

    development: bool = False
    log_level: Optional[int] = None
    log_file: Optional[str] = None
    profile: str = ""
    profile_path: str = "profiles"

    server_network: str = "tcp"
    server_address: str = ":11288"
    server_read_buffer_size: int = 0x0001FFFF
    server_write_buffer_size: int = 256
    server_fsm: str = "config/server_authoritative_fsm.json"
    server_bypass_auth: bool = True
    server_conn_recoverable: bool = False
    server_conn_recover_timeout_ms: int = 0

    client_network_wait_master_server: bool = True
    client_network: str = "tcp"
    client_address: str = ":12108"
    client_read_buffer_size: int = 0x0001FFFF
    client_write_buffer_size: int = 512
    client_fsm: str = "config/client_non_authoritative_fsm.json"

    compression_type: CompressionType = CompressionType.NO_COMPRESSION

    max_connection_id_bits: int = 31

    connection_auth_timeout_ms: int = 5000
    max_failed_auth_attempts: int = 5
    max_fsm_disallowed: int = 10

    spatial_controller_config: Optional[str] = None
    spatial_channel_id_start: int = 0x00010000
    entity_channel_id_start: int = 0x00080000

    channel_settings: dict[ChannelType, ChannelSettings] = field(
        default_factory=lambda: {
            ChannelType.GLOBAL: ChannelSettings(
                tick_interval_ms=10,
                default_fanout_interval_ms=20,
            )
        }
    )

    enable_record_packet: bool = False
    replay_session_persistence_dir: str = ""

    # Python modules imported at init so game-defined protobuf types are
    # resolvable from Any payloads (the reference gets this for free from
    # each main importing its pb package; ours is a flag/config concern).
    import_modules: list[str] = field(default_factory=list)

    # Durable snapshots (new — the reference has no persistence).
    snapshot_path: str = ""
    snapshot_interval_s: float = 30.0

    # Durable write-ahead journal (new — doc/persistence.md). Empty
    # path = the WAL plane stays disarmed and every hook is one
    # attribute load. With a path, every authoritative state transition
    # (coalesced per-tick channel images, handover-journal transitions,
    # placement flips, staged handles, directory versions, blacklists)
    # is appended CRC-framed and fsync-batched on an off-thread writer,
    # so a kill -9 loses at most one fsync batch instead of one
    # snapshot interval; the periodic snapshot checkpoints (truncates)
    # the journal, and boot replays snapshot + WAL tail (a torn final
    # record is truncated at the first bad CRC).
    wal_path: str = ""
    # The writer's fsync batch window: smaller = tighter RPO, more
    # fsyncs. The tick path only ever enqueues; fsync never runs on it.
    wal_fsync_ms: float = 20.0
    # Operator bound on restart-to-serving (boot restore + WAL replay +
    # controller re-seed); overruns warn and fail the crash soak — a
    # slow replay still beats lost state.
    wal_restart_deadline_s: float = 30.0

    # Prometheus /metrics port (the reference hardcodes :8080,
    # metrics.go; a flag lets N gateways share one host).
    metrics_port: int = 8080

    # TPU decision-plane settings (new — no reference counterpart).
    spatial_backend: str = "host"  # "host" | "tpu"
    tpu_entity_capacity: int = 1 << 17
    tpu_query_capacity: int = 1 << 12
    # Torch device of the spatial engine: "cuda" (default; raises
    # without a card) or "cpu" only when asked for.
    spatial_device: str = "cuda"
    # Chaos fault-injection scenario JSON (new — see doc/chaos.md).
    # Empty = the injector stays disarmed and every hook is a no-op.
    chaos_config: str = ""

    # Overload governor (new — doc/overload.md). The four-level
    # degradation ladder: enter/exit thresholds are deliberately apart
    # (hysteresis), the ladder moves one step per GLOBAL tick at most,
    # and de-escalation additionally requires the smoothed pressure to
    # hold under the exit threshold for overload_down_hold_s.
    # Thresholds are budget-utilization style (1.0 == the tick exactly
    # spends its budget): degradation starts when the gateway OVERRUNS,
    # not when it is merely busy — a tick at 80% of budget is healthy.
    overload_enabled: bool = True
    overload_alpha: float = 0.25  # EWMA smoothing of the raw pressure
    overload_enter_thresholds: tuple = (0.95, 1.15, 1.40)  # L1/L2/L3
    overload_exit_thresholds: tuple = (0.75, 1.00, 1.20)
    overload_up_hold_ticks: int = 3
    overload_down_hold_s: float = 2.0
    # After a step down, up-transitions wait out this cooldown so the
    # release itself (resumed fan-outs, full-state resyncs, the
    # deferred-handover drain) cannot bounce the ladder straight back
    # up. If the release work is genuinely heavy the governor may still
    # re-brake afterwards — by design it just never climbs above the
    # overload's own peak on the way down.
    overload_up_cooldown_s: float = 3.0
    overload_l1_stretch: float = 2.0  # fan-out interval multiplier
    overload_l2_stretch: float = 4.0
    overload_backlog_norm: int = 64  # stash-parked conns == pressure 1.0
    # L3 hard accept gate: unauthenticated connections tolerated before
    # raw CLIENT accepts are refused outright (separate knob from the
    # pressure normalizer above — they tune independently).
    overload_accept_headroom: int = 256
    overload_handover_batch_cap: int = 256  # crossings/tick at L2+
    overload_retry_after_ms: int = 2000  # ServerBusyMessage back-off

    # Adversarial edge plane (new — doc/edge_hardening.md): the
    # per-connection resource envelope. Unlike the overload ladder
    # (global, load-driven), the edge plane is PER-PEER: one broken or
    # hostile socket is bounded, resynced, quarantined and finally
    # disconnected without the rest of the fleet noticing.
    edge_enabled: bool = True
    # Egress envelope: the send queue is bounded in entries AND bytes.
    # Past either cap the oldest entries are dropped (counted,
    # egress_dropped_total) and every SHED-eligible subscription of the
    # connection is marked for full-state resync — a bounded queue
    # degrades to a coarser cadence, never to silent state loss.
    edge_send_queue_max_msgs: int = 8192
    edge_send_queue_max_bytes: int = 4 * 1024 * 1024
    # Watermarks as fractions of either cap. Above HIGH the connection
    # is a slow-consumer suspect; back under LOW it is healthy again
    # (the gap is hysteresis — a queue oscillating around one threshold
    # must not flap the suspect state).
    edge_high_watermark: float = 0.5
    edge_low_watermark: float = 0.125
    # Sustained-high grace: a connection holding above HIGH for this
    # long is dropped-to-resync once; holding for another full grace
    # window after that escalates to quarantine.
    edge_slow_grace_s: float = 2.0
    # Quarantine -> structured disconnect deadline. While quarantined
    # the egress queue is frozen (nothing new enqueued) and the peer is
    # sent nothing but the final DisconnectMessage.
    edge_quarantine_grace_s: float = 1.0
    # Ingress accumulation bound: a per-connection frames/s cap (token
    # bucket, burst = one second's allowance; 0 disables). Sustained
    # violation quarantines the peer (ingress_flood). Frame-SIZE bounds
    # are the framing layer's MAX_PACKET_SIZE (connection-fatal,
    # counted malformed_frames_total{stage=framing}).
    edge_max_frame_rate: int = 4000
    # Per-tick drain fairness: send-queue entries one connection may
    # flush per pump pass before it yields (re-queued for the next
    # pass); 0 disables the bound. Keeps one hot connection from
    # starving the 1ms pump for everyone else.
    edge_flush_fair_msgs: int = 4096
    # Transport-backpressure gate: when a connection's transport reports
    # more than this many unsent bytes buffered (a peer not draining its
    # socket), the shared pump stops feeding it and leaves the entries
    # in the send queue — which is what the envelope bounds and the
    # slow-consumer ladder watches. Without the gate a slow TCP reader
    # hides in the transport's unbounded-in-practice write buffer until
    # the MAX_SEND_BUFFER abort; with it the peer walks the counted
    # ladder (resync -> quarantine -> structured disconnect) instead.
    # 0 disables. Direct flushes (disconnect, drain) bypass the gate.
    edge_transport_high_bytes: int = 1 << 20
    # Auth-window deadline (-auth-deadline, ms): sockets that never
    # complete the FSM handshake within it are reaped and counted
    # (conn_reaped_total{reason=auth_timeout}); recovery-handle
    # reconnects are exempt. 0 = inherit connection_auth_timeout_ms
    # (the reference's -cat knob) so existing configs keep their
    # behavior.
    auth_deadline_ms: int = 0

    # Spatial authority failover (new — doc/failover.md). When a
    # recoverable server's recovery window expires for good, its
    # orphaned spatial cells are re-hosted onto surviving servers
    # (fewest-owned-cells first) instead of going dark. The deadline is
    # the operator's bound on one failover pass; overruns only warn —
    # a slow re-host still beats a dead cell.
    failover_enabled: bool = True
    failover_rehost_deadline_s: float = 5.0
    # Entity weight in the shared placement score (core/failover.py
    # placement_score, used by failover re-host AND the balancer): one
    # hosted entity costs this many owned cells — a server with few but
    # huge cells is no longer mis-ranked as idle.
    failover_placement_entity_weight: float = 0.0625

    # Live spatial load balancer (new — doc/balancer.md). Planned,
    # zero-loss migration of live cells between live servers: the
    # balancer folds per-server load (entities, crossing rate, fan-out
    # bytes, overload pressure) into an imbalance score (max/mean) with
    # two-sided hysteresis, a per-epoch migration budget and a per-cell
    # post-migration cooldown so it never flaps and never fights the
    # overload ladder (migrations are vetoed at L2+).
    balancer_enabled: bool = True
    balancer_imbalance_enter: float = 1.6
    balancer_imbalance_exit: float = 1.25
    balancer_hold_ticks: int = 5  # consecutive over-threshold updates
    balancer_epoch_ticks: int = 300  # GLOBAL ticks per migration epoch
    balancer_budget_per_epoch: int = 2  # committed migrations per epoch
    balancer_cooldown_ticks: int = 600  # per-cell re-migration lockout
    # Hottest-coldest per-server entity gap below which the world is too
    # small to be worth migrating (keeps tiny test worlds untouched).
    balancer_min_entity_delta: int = 8
    # Freeze-phase bounds, in GLOBAL ticks: at least min (queued entity
    # hops on the cell channel must run before the bootstrap snapshot),
    # at most the drain deadline (a journal that never clears aborts the
    # migration back to the old owner).
    balancer_freeze_min_ticks: int = 2
    balancer_drain_deadline_ticks: int = 120
    # Load-fold weights: one crossing per update == this many entities;
    # one KiB of fan-out per update == this many; one unit of per-server
    # overload pressure == this many.
    balancer_crossing_weight: float = 2.0
    balancer_bytes_weight: float = 0.5
    balancer_pressure_weight: float = 32.0
    # Per-destination veto: a candidate whose exported overload pressure
    # is at/above this never receives a migration (the gateway-wide
    # ladder at L2+ vetoes ALL migrations regardless).
    balancer_dest_pressure_max: float = 1.15

    # Adaptive partitioning (new — doc/partitioning.md). Cell geometry
    # becomes a runtime, versioned property: a density governor splits
    # hot cells quadtree-style and merges cold sibling groups back,
    # executed as transactional geometry epochs (freeze -> drain ->
    # commit/abort) riding the balancer's freeze machinery and the WAL.
    # OFF by default: every pre-existing envelope assumes the static
    # grid; soaks that want it opt in explicitly.
    partition_enabled: bool = False
    # Structural depth bound: the cell-id blocks for depths
    # 0..partition_max_depth are reserved at load (validated against
    # entity_channel_id_start), whether or not the governor is enabled.
    partition_max_depth: int = 2
    # Split when a cell's resident entities hold at/above this; merge a
    # sibling group when the group TOTAL holds at/below the merge
    # threshold (kept well apart — two-sided hysteresis, no flapping).
    partition_split_entities: int = 48
    partition_merge_entities: int = 12
    # Consecutive over/under-threshold evaluations before acting, and
    # GLOBAL ticks between evaluations.
    partition_hold_ticks: int = 3
    partition_eval_ticks: int = 30
    # Committed geometry ops per epoch, epoch length, and per-cell
    # re-op lockout — the balancer's anti-flap discipline.
    partition_budget_per_epoch: int = 1
    partition_epoch_ticks: int = 300
    partition_cooldown_ticks: int = 600
    # Freeze-phase bounds (GLOBAL ticks): minimum freeze before the
    # repartition snapshot; a handover journal that never drains aborts.
    partition_freeze_min_ticks: int = 2
    partition_drain_deadline_ticks: int = 120

    # Standing-query plane (new — doc/query_engine.md). With the TPU
    # backend every standing interest (entity followers, client AOI
    # queries, server sensors) becomes a device query row: one batched
    # mask pass + on-device diff per tick, one changed-rows transfer,
    # O(changed) host apply. ON by default with spatial_backend=tpu;
    # host backend ignores it (host interest stays per-query).
    queryplane_enabled: bool = True
    # Changed-rows budget per tick (the fixed compaction width; changes
    # beyond it stay in the device baseline and re-emit next tick).
    queryplane_rows_max: int = 8192
    # Upper bound on a client spots query's spot list — beyond this the
    # UpdateSpatialInterest message is rejected as malformed.
    queryplane_max_spots: int = 256

    # Simulation plane (new — doc/simulation.md). OFF by default: when
    # enabled the gateway hosts a server-driven agent population
    # stepped ON DEVICE inside the guarded spatial tick — agents occupy
    # ordinary entity slots, so crossings, handover, partitioning,
    # standing queries and fan-out see them exactly like humans, with
    # zero extra device<->host transfers per tick.
    sim_enabled: bool = False
    # Population spawned at controller load (ignored when a WAL-replayed
    # census restores the exact prior population instead).
    sim_agents: int = 1000
    # Counter-based RNG seed: same seed + same tick count = the same
    # trajectories, bit-exact (the replayability contract).
    sim_seed: int = 1
    # Sim passes per spatial tick denominator: step every Nth tick
    # (1 = every tick). The overload ladder's L2 additionally halves
    # this cadence (skips every other scheduled pass) before human
    # traffic degrades.
    sim_step_every_ticks: int = 1
    # Census cadence: every Nth SIM pass the kinematic columns are
    # fetched (the plane's only readback), folded into the host shadow,
    # journaled to the WAL, and committed through the authority path.
    sim_census_every_ticks: int = 50
    # World-time integration step per sim pass, seconds, and the
    # kinematic envelope (units/s, units/s^2).
    sim_step_dt: float = 0.05
    sim_max_speed: float = 6.0
    sim_accel: float = 24.0
    # Steering weights: separation pushes agents out of cells more
    # crowded than sim_crowd occupants; cohesion pulls strays toward
    # their cell's centroid.
    sim_separation: float = 0.6
    sim_cohesion: float = 0.15
    sim_crowd: int = 32
    # Waypoint arrival radius (world units) and the per-tick FSM dice:
    # idle->wander, wander->seek, wander->idle probabilities.
    sim_arrive_radius: float = 1.5
    sim_p_wander: float = 0.2
    sim_p_seek: float = 0.1
    sim_p_idle: float = 0.05
    # Cap on CHANNEL-BACKED agents: up to this many agents get real
    # entity channels owned by the internal authority connection (full
    # handover/fan-out semantics). Agents beyond the cap are engine-only
    # (device-tracked, no channel data — crossings need no
    # orchestration); intended for engine-direct benches at 100K+.
    sim_channel_agents: int = 4096
    # Channel attachments performed per tick while the world boots (the
    # authority retries cells whose channels don't exist yet).
    sim_attach_per_tick: int = 256

    # Cross-gateway federation plane (new — doc/federation.md). Empty
    # config path = the plane stays disarmed and every hook is a cheap
    # no-op (the gateway is a self-contained world, the pre-federation
    # behavior). With a config, G gateways jointly host one spatial
    # world: each owns the server blocks the directory assigns it,
    # trunk links carry cross-gateway handovers (the PR 3 transactional
    # journal extended over the wire), and clients whose interest
    # anchor crosses a shard boundary are redirected with a pre-staged
    # recovery handle.
    federation_config: str = ""
    federation_gateway_id: str = ""
    federation_heartbeat_ms: int = 500
    # Heartbeats missed (as a time window) before the trunk is declared
    # down and in-flight handovers toward that peer abort back to src.
    federation_trunk_timeout_ms: int = 2500
    # One cross-gateway handover batch's prepare->ack deadline; a batch
    # past it aborts (restore to src) even on a live trunk.
    federation_handover_timeout_ms: int = 3000
    # Reconnect backoff: base * 2^attempt, capped, +-20% jitter
    # (federation/trunk.py backoff_schedule — unit-tested).
    federation_reconnect_base_ms: int = 100
    federation_reconnect_max_ms: int = 5000

    # Global control plane (new — doc/global_control.md). Only armed
    # when the federation plane is (it rides the trunks): each gateway
    # exports a load vector + replicates its shard state to every trunk
    # peer once per control epoch; the deterministic leader (lowest
    # live gateway id) folds the vectors into a fleet max/mean
    # imbalance and plans per-cell cross-gateway shard migrations with
    # the balancer's guard discipline (hysteresis, budget, cooldown,
    # improvement, hard veto at overload L2+); a gateway whose trunks
    # stay silent past the miss threshold is declared dead by the
    # leader and its shard is adopted by the least-loaded survivor from
    # the epoch replica.
    global_control_enabled: bool = True
    global_epoch_ms: int = 500
    global_imbalance_enter: float = 1.5
    global_imbalance_exit: float = 1.2
    global_hold_epochs: int = 3
    # Committed shard migrations allowed per budget window, and the
    # window itself (in control epochs).
    global_budget_per_window: int = 2
    global_budget_window_epochs: int = 20
    # Per-cell re-migration lockout after a terminal plan, in epochs.
    global_cooldown_epochs: int = 20
    # Hottest-coldest per-gateway entity gap below which the fleet is
    # too small/even to be worth moving shards around.
    global_min_entity_delta: int = 8
    # Consecutive epochs a peer's trunk must stay down before the
    # leader declares it dead and reassigns its shard.
    global_death_miss_epochs: int = 4
    # One shard-migration plan's leader-side deadline (plan -> terminal
    # TrunkMigrateStatus), and the adoption census handshake's wait for
    # survivor claims.
    global_migrate_timeout_ms: int = 8000
    global_adopt_claims_timeout_ms: int = 750

    # Device supervision & in-process engine recovery (new —
    # doc/device_recovery.md). The device step runs under a watchdog:
    # the guarded step is dispatched to a dedicated worker thread and
    # the tick waits at most ``device_step_deadline_s`` (the jax call
    # blocks, so hang detection must be off-thread). Transient step
    # errors retry with exponential backoff up to ``device_retry_max``
    # attempts; a hang, a sentinel-detected corruption, or an exhausted
    # retry budget is FATAL and triggers an in-process engine rebuild
    # from the host-side shadow (entity registry, query params, sub
    # intervals, placement ledger), verified bit-identical before the
    # gateway resumes device service. While the engine is down the
    # gateway degrades instead of dying: device-dependent work is held
    # and the overload ladder is pinned to L2+.
    device_guard_enabled: bool = True
    device_step_deadline_s: float = 2.0
    device_retry_max: int = 2
    device_retry_backoff_ms: int = 100
    # Operator bound on one full recovery (failure detect -> verified
    # rebuilt engine serving again); overruns warn and fail soaks — a
    # slow recovery still beats a dead gateway.
    device_recovery_deadline_s: float = 10.0

    # Flight recorder (new — doc/observability.md). Always-on by
    # default: the recorder is fixed-memory (per-thread span rings) and
    # its hot-path cost is two clock reads + a ring store per tick
    # stage (<3% of the tick hot path, measured in TRACE_r11.json).
    # Disabling it only stops span recording and anomaly auto-dumps;
    # the tick_stage_ms histograms keep moving either way.
    trace_enabled: bool = True
    trace_ring_spans: int = 8192  # spans kept per writer thread
    trace_dump_ticks: int = 200  # ticks frozen into an anomaly dump
    trace_anomaly_cooldown_s: float = 5.0

    # Fleet health plane (new — doc/observability.md). With the SLO
    # plane armed, forwarded updates carry a monotonic ingest stamp to
    # the fan-out send (delivery_latency_ms — the live measurement
    # behind the < 5ms p99 claim), a declarative SLO table (delivery
    # p99, tick budget, trunk RTT, WAL fsync RPO) is evaluated
    # in-process with multi-window burn rates every GLOBAL tick, each
    # breach freezes a flight-recorder slo_breach anomaly dump, and
    # federated gateways attach a metric digest to the control-epoch
    # load report so any gateway's /fleet endpoint shows the whole
    # fleet in one scrape. Soaks with deterministic envelopes pin the
    # plane off (their accounting predates the extra samples).
    slo_enabled: bool = True
    # Operator SLO table (JSON list of core/slo.py SloSpec rows);
    # empty = the built-in defaults.
    slo_config: str = ""

    # Runtime thread-affinity assertions (doc/concurrency.md): the
    # static thread model's runtime twin. Off in production by default
    # (hooks cost one attribute load); tier-1 arms it for the whole
    # run via tests/conftest.py, and -debug-affinity arms it on a live
    # gateway (violations are recorded + warned, never raised).
    debug_affinity: bool = False

    # Device mesh for the spatial engine: 0 devices = single-device step;
    # N>0 shards the entity arrays over the first N jax devices, and
    # hosts>1 arranges them as a (hosts, chips) DCN x ICI mesh — the TPU
    # equivalent of the reference's multi-server spatial world
    # (ref: spatial.go:387-590).
    tpu_mesh_devices: int = 0
    tpu_mesh_hosts: int = 1

    def effective_auth_deadline_ms(self) -> int:
        """The auth-window reap deadline the edge plane enforces:
        -auth-deadline when set, else the reference -cat knob."""
        if self.auth_deadline_ms > 0:
            return self.auth_deadline_ms
        return self.connection_auth_timeout_ms

    def get_channel_settings(self, ct: ChannelType) -> ChannelSettings:
        # By-value copy, like the Go struct return — mutating the result
        # must not silently retune another channel type's settings.
        st = self.channel_settings_view(ct)
        return replace(st, acl=replace(st.acl))

    def channel_settings_view(self, ct: ChannelType) -> ChannelSettings:
        """Read-only view (no defensive copy): for hot paths that only
        READ settings — the copying form is two dataclasses.replace per
        call, visible at handover-batch rates. Callers must not mutate."""
        st = self.channel_settings.get(ct)
        if st is None:
            st = self.channel_settings.get(ChannelType.GLOBAL)
            if st is None:
                st = ChannelSettings()
        return st

    def load_channel_settings(self, path: str) -> None:
        """Load the reference-schema channel settings JSON (keys = numeric type)."""
        with open(path) as f:
            raw = json.load(f)
        for key, val in raw.items():
            self.channel_settings[ChannelType(int(key))] = ChannelSettings.from_dict(val)

    def parse_flags(self, argv: Optional[list[str]] = None) -> None:
        """CLI flags, names matching the reference (ref: settings.go:144-235)."""
        # allow_abbrev=False: Go's flag package (which the reference CLI
        # uses) never prefix-matches, and abbreviation lets a typo like
        # `-imp x` silently bind to -imports.
        p = argparse.ArgumentParser(
            prog="channeld-tpu", add_help=True, allow_abbrev=False
        )
        p.add_argument("-dev", action="store_true", help="run in development mode")
        p.add_argument("-loglevel", type=int, default=None,
                       help="-1 Debug, 0 Info, 1 Warn, 2 Error")
        p.add_argument("-logfile", type=str, default=None)
        p.add_argument("-profile", type=str, default="",
                       help="cpu | mem | gpu | tasks (process profile, "
                            "device trace, or asyncio task dump)")
        p.add_argument("-profilepath", type=str, default=self.profile_path)
        p.add_argument("-sn", type=str, default=self.server_network,
                       help="server network type: tcp | ws")
        p.add_argument("-sa", type=str, default=self.server_address)
        p.add_argument("-srb", type=int, default=self.server_read_buffer_size)
        p.add_argument("-swb", type=int, default=self.server_write_buffer_size)
        p.add_argument("-sfsm", type=str, default=self.server_fsm)
        p.add_argument("-sba", type=lambda s: s.lower() != "false",
                       default=self.server_bypass_auth,
                       help="server bypasses authentication")
        p.add_argument("-scr", action="store_true",
                       help="server connections recoverable")
        p.add_argument("-scrt", type=int, default=self.server_conn_recover_timeout_ms)
        p.add_argument("-cwm", type=lambda s: s.lower() != "false",
                       default=self.client_network_wait_master_server)
        p.add_argument("-cn", type=str, default=self.client_network)
        p.add_argument("-ca", type=str, default=self.client_address)
        p.add_argument("-crb", type=int, default=self.client_read_buffer_size)
        p.add_argument("-cwb", type=int, default=self.client_write_buffer_size)
        p.add_argument("-cfsm", type=str, default=self.client_fsm)
        p.add_argument("-erp", action="store_true",
                       help="record packets sent from clients")
        p.add_argument("-rspd", type=str, default="")
        p.add_argument("-ct", type=int, default=0, help="0 = none, 1 = snappy")
        p.add_argument("-scc", type=str, default=None,
                       help="spatial controller config JSON path")
        p.add_argument("-scs", type=int, default=self.spatial_channel_id_start)
        p.add_argument("-ecs", type=int, default=self.entity_channel_id_start)
        p.add_argument("-mcb", type=int, default=self.max_connection_id_bits)
        p.add_argument("-cat", type=int, default=self.connection_auth_timeout_ms)
        p.add_argument("-mfaa", type=int, default=self.max_failed_auth_attempts)
        p.add_argument("-mfd", type=int, default=self.max_fsm_disallowed)
        p.add_argument("-chs", type=str, default="config/channel_settings_hifi.json")
        p.add_argument("-imports", type=str, default="",
                       help="comma-separated Python modules providing game "
                            "protobuf types (e.g. mygame.data_pb2)")
        p.add_argument("-snapshot", type=str, default="",
                       help="path for periodic gateway state snapshots; "
                            "restored at boot when present")
        p.add_argument("-mport", type=int, default=self.metrics_port,
                       help="Prometheus /metrics port (0 disables)")
        p.add_argument("-wal", type=str, default="",
                       help="path for the durable write-ahead journal "
                            "(doc/persistence.md); replayed over the "
                            "snapshot at boot, truncated by each "
                            "snapshot write; empty disables")
        p.add_argument("-wal-fsync-ms", type=float,
                       default=self.wal_fsync_ms,
                       help="WAL fsync batch window (off-thread writer; "
                            "the RPO of a kill -9)")
        p.add_argument("-snapshot-interval", type=float,
                       default=self.snapshot_interval_s)
        p.add_argument("-spatial-backend", type=str, default=self.spatial_backend,
                       choices=("host", "tpu"),
                       help="where the AOI/fan-out decision pass runs")
        p.add_argument("-spatial-device", type=str, default=self.spatial_device,
                       help="torch device of the spatial engine: cuda "
                            "(default) or cpu")
        p.add_argument("-chaos", type=str, default="",
                       help="chaos scenario JSON path; arms deterministic "
                            "fault injection (doc/chaos.md)")
        p.add_argument("-overload",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.overload_enabled,
                       help="adaptive overload-control ladder "
                            "(doc/overload.md); false pins L0")
        p.add_argument("-overload-retry-after", type=int,
                       default=self.overload_retry_after_ms,
                       help="retry-after (ms) in L3 ServerBusyMessage "
                            "admission refusals")
        p.add_argument("-overload-down-hold", type=float,
                       default=self.overload_down_hold_s,
                       help="seconds the pressure must hold under the exit "
                            "threshold before the ladder steps down")
        p.add_argument("-failover",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.failover_enabled,
                       help="re-host a dead server's spatial cells onto "
                            "surviving servers (doc/failover.md); false "
                            "leaves them ownerless")
        p.add_argument("-failover-deadline", type=float,
                       default=self.failover_rehost_deadline_s,
                       help="seconds one failover pass may take before "
                            "the overrun is logged as a warning")
        p.add_argument("-balancer",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.balancer_enabled,
                       help="live spatial load balancer: planned "
                            "zero-loss cell migration between live "
                            "servers (doc/balancer.md); false pins the "
                            "static placement")
        p.add_argument("-balancer-imbalance", type=float,
                       default=self.balancer_imbalance_enter,
                       help="max/mean per-server load ratio above which "
                            "a migration is planned (exit threshold "
                            "stays at its default unless retuned in "
                            "code)")
        p.add_argument("-balancer-budget", type=int,
                       default=self.balancer_budget_per_epoch,
                       help="committed migrations allowed per epoch "
                            "(epoch = balancer_epoch_ticks GLOBAL "
                            "ticks)")
        p.add_argument("-balancer-cooldown", type=int,
                       default=self.balancer_cooldown_ticks,
                       help="GLOBAL ticks a migrated cell is locked out "
                            "of re-migration (anti-oscillation)")
        p.add_argument("-partition",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.partition_enabled,
                       help="adaptive partitioning: live quadtree cell "
                            "split/merge under extreme density "
                            "(doc/partitioning.md); false pins the "
                            "static grid geometry")
        p.add_argument("-partition-split", type=int,
                       default=self.partition_split_entities,
                       help="resident entities at/above which a cell is "
                            "planned for a split")
        p.add_argument("-partition-merge", type=int,
                       default=self.partition_merge_entities,
                       help="sibling-group total at/below which a merge "
                            "is planned")
        p.add_argument("-partition-depth", type=int,
                       default=self.partition_max_depth,
                       help="max quadtree split depth (id space for all "
                            "depths is validated against the entity "
                            "channel id start)")
        p.add_argument("-partition-budget", type=int,
                       default=self.partition_budget_per_epoch,
                       help="committed geometry ops allowed per epoch "
                            "(epoch = partition_epoch_ticks GLOBAL "
                            "ticks)")
        p.add_argument("-queryplane",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.queryplane_enabled,
                       help="device standing-query plane: followers, "
                            "client AOI queries and server sensors "
                            "evaluated in one batched device pass per "
                            "tick (doc/query_engine.md); false keeps "
                            "the per-follower host readback path")
        p.add_argument("-queryplane-rows", type=int,
                       default=self.queryplane_rows_max,
                       help="changed (query, cell, dist) rows budget per "
                            "tick; overflow re-emits next tick")
        p.add_argument("-queryplane-max-spots", type=int,
                       default=self.queryplane_max_spots,
                       help="max spots per client spots query; larger "
                            "lists are rejected as malformed")
        p.add_argument("-sim",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.sim_enabled,
                       help="device simulation plane: a server-driven "
                            "agent population stepped on device inside "
                            "the guarded spatial tick "
                            "(doc/simulation.md); agents are ordinary "
                            "entities to every other plane")
        p.add_argument("-sim-agents", type=int, default=self.sim_agents,
                       help="population spawned at controller load "
                            "(a WAL-replayed census wins over this)")
        p.add_argument("-sim-seed", type=int, default=self.sim_seed,
                       help="counter-based RNG seed: same seed + tick "
                            "count = bit-exact trajectories")
        p.add_argument("-sim-census", type=int,
                       default=self.sim_census_every_ticks,
                       help="census cadence in sim passes: the plane's "
                            "only device readback, folded to the host "
                            "shadow + WAL + authority path")
        p.add_argument("-fed", type=str, default="",
                       help="federation config JSON path (shard directory "
                            "+ trunk addresses, doc/federation.md); empty "
                            "disables the federation plane")
        p.add_argument("-fed-id", type=str, default="",
                       help="this gateway's id in the federation config")
        p.add_argument("-global-control",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.global_control_enabled,
                       help="federation-level control plane: cross-"
                            "gateway shard rebalancing + gateway-death "
                            "failover (doc/global_control.md); false "
                            "pins the static shard map")
        p.add_argument("-global-epoch-ms", type=int,
                       default=self.global_epoch_ms,
                       help="control-epoch cadence: load-vector export, "
                            "shard replication, leader planning")
        p.add_argument("-global-imbalance", type=float,
                       default=self.global_imbalance_enter,
                       help="max/mean per-gateway load ratio above which "
                            "the leader plans a shard migration")
        p.add_argument("-global-death-epochs", type=int,
                       default=self.global_death_miss_epochs,
                       help="consecutive control epochs a trunk must "
                            "stay down before the leader declares the "
                            "gateway dead and re-hosts its shard")
        p.add_argument("-device-guard",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.device_guard_enabled,
                       help="device watchdog + in-process engine "
                            "recovery (doc/device_recovery.md); false "
                            "runs the device step unguarded")
        p.add_argument("-device-deadline", type=float,
                       default=self.device_step_deadline_s,
                       help="seconds one guarded device step may take "
                            "before it is declared hung (fatal; the "
                            "engine rebuilds from the host shadow)")
        p.add_argument("-device-recovery-deadline", type=float,
                       default=self.device_recovery_deadline_s,
                       help="seconds one full device recovery (failure "
                            "detect -> verified rebuild) may take "
                            "before the overrun is logged as a warning")
        p.add_argument("-trace",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.trace_enabled,
                       help="flight-recorder span recording + anomaly "
                            "auto-dumps (doc/observability.md); false "
                            "keeps only the tick_stage_ms histograms")
        p.add_argument("-trace-ring", type=int,
                       default=self.trace_ring_spans,
                       help="spans kept per writer thread (fixed memory; "
                            "overflow drops the oldest, counted exactly)")
        p.add_argument("-trace-dump-ticks", type=int,
                       default=self.trace_dump_ticks,
                       help="GLOBAL ticks frozen into an anomaly dump")
        p.add_argument("-slo",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.slo_enabled,
                       help="delivery-SLO plane: ingest->fan-out "
                            "latency stamping, burn-rate tracking, "
                            "breach anomaly dumps, fleet metric "
                            "digests (doc/observability.md); false "
                            "disarms every hook")
        p.add_argument("-slo-config", type=str, default=self.slo_config,
                       help="JSON SLO table overriding the built-in "
                            "defaults (core/slo.py SloSpec rows)")
        p.add_argument("-edge",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.edge_enabled,
                       help="adversarial edge plane: per-connection "
                            "resource envelopes, slow-consumer "
                            "quarantine, ingress caps "
                            "(doc/edge_hardening.md); false disarms "
                            "every bound")
        p.add_argument("-edge-queue-msgs", type=int,
                       default=self.edge_send_queue_max_msgs,
                       help="per-connection egress queue entry cap")
        p.add_argument("-edge-queue-bytes", type=int,
                       default=self.edge_send_queue_max_bytes,
                       help="per-connection egress queue byte cap")
        p.add_argument("-edge-frame-rate", type=int,
                       default=self.edge_max_frame_rate,
                       help="per-connection inbound frames/s cap "
                            "(0 disables)")
        p.add_argument("-auth-deadline", type=int,
                       default=self.auth_deadline_ms,
                       help="ms a socket may stay unauthenticated before "
                            "it is reaped (conn_reaped_total); 0 "
                            "inherits -cat")
        p.add_argument("-debug-affinity",
                       type=lambda s: s.lower() not in
                       ("false", "0", "no", "off"),
                       default=self.debug_affinity,
                       help="arm runtime thread-affinity assertions "
                            "(doc/concurrency.md): violations of the "
                            "declared thread model are recorded and "
                            "logged at warning")
        p.add_argument("-mesh-devices", type=int, default=self.tpu_mesh_devices,
                       help="shard the spatial engine over N devices "
                            "(0 = single-device step)")
        p.add_argument("-mesh-hosts", type=int, default=self.tpu_mesh_hosts,
                       help="arrange the mesh devices as (hosts, chips)")
        args = p.parse_args(argv)

        self.development = args.dev
        self.log_level = args.loglevel
        self.log_file = args.logfile
        self.profile = args.profile
        self.profile_path = args.profilepath
        self.server_network = args.sn
        self.server_address = args.sa
        self.server_read_buffer_size = args.srb
        self.server_write_buffer_size = args.swb
        self.server_fsm = args.sfsm
        self.server_bypass_auth = args.sba
        self.server_conn_recoverable = args.scr
        self.server_conn_recover_timeout_ms = args.scrt
        self.client_network_wait_master_server = args.cwm
        self.client_network = args.cn
        self.client_address = args.ca
        self.client_read_buffer_size = args.crb
        self.client_write_buffer_size = args.cwb
        self.client_fsm = args.cfsm
        self.enable_record_packet = args.erp
        self.replay_session_persistence_dir = args.rspd
        self.compression_type = CompressionType(args.ct)
        self.spatial_controller_config = args.scc
        self.spatial_channel_id_start = args.scs
        self.entity_channel_id_start = args.ecs
        self.max_connection_id_bits = args.mcb
        self.connection_auth_timeout_ms = args.cat
        self.max_failed_auth_attempts = args.mfaa
        self.max_fsm_disallowed = args.mfd
        self.chaos_config = args.chaos
        self.overload_enabled = args.overload
        self.overload_retry_after_ms = args.overload_retry_after
        self.overload_down_hold_s = args.overload_down_hold
        self.failover_enabled = args.failover
        self.failover_rehost_deadline_s = args.failover_deadline
        self.balancer_enabled = args.balancer
        self.balancer_imbalance_enter = args.balancer_imbalance
        # The flag only moves the ENTER threshold; keep the exit strictly
        # below it or the two-sided hysteresis band inverts (armed one
        # tick, disarmed the next, forever).
        self.balancer_imbalance_exit = min(
            self.balancer_imbalance_exit, args.balancer_imbalance * 0.8
        )
        self.balancer_budget_per_epoch = args.balancer_budget
        self.balancer_cooldown_ticks = args.balancer_cooldown
        self.partition_enabled = args.partition
        self.partition_split_entities = args.partition_split
        # Keep the merge threshold strictly under the split threshold or
        # the two-sided density hysteresis band inverts (split one
        # epoch, merge the next, forever).
        self.partition_merge_entities = min(
            args.partition_merge, args.partition_split // 2,
        )
        self.partition_max_depth = args.partition_depth
        self.partition_budget_per_epoch = args.partition_budget
        self.queryplane_enabled = args.queryplane
        self.queryplane_rows_max = args.queryplane_rows
        self.queryplane_max_spots = args.queryplane_max_spots
        self.sim_enabled = args.sim
        self.sim_agents = args.sim_agents
        self.sim_seed = args.sim_seed
        self.sim_census_every_ticks = args.sim_census
        self.federation_config = args.fed
        self.federation_gateway_id = args.fed_id
        self.global_control_enabled = args.global_control
        self.global_epoch_ms = args.global_epoch_ms
        self.global_imbalance_enter = args.global_imbalance
        # Same hysteresis-band guard as the balancer flag: the exit
        # threshold must stay strictly under the enter threshold.
        self.global_imbalance_exit = min(
            self.global_imbalance_exit, args.global_imbalance * 0.85
        )
        self.global_death_miss_epochs = args.global_death_epochs
        self.device_guard_enabled = args.device_guard
        self.device_step_deadline_s = args.device_deadline
        self.device_recovery_deadline_s = args.device_recovery_deadline
        self.trace_enabled = args.trace
        self.trace_ring_spans = args.trace_ring
        self.trace_dump_ticks = args.trace_dump_ticks
        self.slo_enabled = args.slo
        self.slo_config = args.slo_config
        self.edge_enabled = args.edge
        self.edge_send_queue_max_msgs = args.edge_queue_msgs
        self.edge_send_queue_max_bytes = args.edge_queue_bytes
        self.edge_max_frame_rate = args.edge_frame_rate
        self.auth_deadline_ms = args.auth_deadline
        self.debug_affinity = args.debug_affinity
        self.spatial_backend = args.spatial_backend
        self.spatial_device = args.spatial_device
        self.tpu_mesh_devices = args.mesh_devices
        self.tpu_mesh_hosts = args.mesh_hosts
        self.snapshot_path = args.snapshot
        self.snapshot_interval_s = args.snapshot_interval
        self.wal_path = args.wal
        self.wal_fsync_ms = args.wal_fsync_ms
        self.metrics_port = args.mport
        self.import_modules = [m for m in args.imports.split(",") if m]
        self.load_channel_settings(args.chs)


# The process-wide settings instance (ref: settings.go ``GlobalSettings``).
global_settings = GlobalSettings()


def reset_global_settings() -> None:
    """Test hook: restore defaults."""
    global global_settings
    fresh = GlobalSettings()
    for f in fresh.__dataclass_fields__:
        setattr(global_settings, f, getattr(fresh, f))
