"""Prometheus metrics (ref: pkg/channeld/metrics.go:7-131).

Same metric families as the reference — message/packet/byte rates in and
out, dropped/fragmented/combined packets, live connection and channel
gauges, per-channel-type tick duration — plus new TPU decision-plane
metrics (device step latency, AOI batch size).
"""

from __future__ import annotations

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    start_http_server,
)

registry = CollectorRegistry()

msg_received = Counter(
    "messages_in", "Messages received", ["conn_type", "channel_type", "msg_type"],
    registry=registry,
)
msg_sent = Counter(
    "messages_out", "Messages sent", ["conn_type", "channel_type", "msg_type"],
    registry=registry,
)
packet_received = Counter(
    "packets_in", "Packets received", ["conn_type"], registry=registry
)
packet_sent = Counter("packets_out", "Packets sent", ["conn_type"], registry=registry)
bytes_received = Counter("bytes_in", "Bytes received", ["conn_type"], registry=registry)
bytes_sent = Counter("bytes_out", "Bytes sent", ["conn_type"], registry=registry)
packet_dropped = Counter(
    "packets_drop", "Dropped packets", ["conn_type"], registry=registry
)
packet_fragmented = Counter(
    "packets_frag", "Partially-read packets", ["conn_type"], registry=registry
)
packet_combined = Counter(
    "packets_comb", "Messages combined into one packet", ["conn_type"],
    registry=registry,
)
connection_num = Gauge(
    "connection_num", "Live connections", ["conn_type"], registry=registry
)
channel_num = Gauge("channel_num", "Live channels", ["channel_type"], registry=registry)
connection_closed = Counter(
    "connection_closed", "Connections closed", ["conn_type"], registry=registry
)
channel_tick_duration = Histogram(
    "channel_tick_duration",
    "Channel tick duration",
    ["channel_type"],
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5),
    registry=registry,
)
fanout_decision_latency = Histogram(
    "fanout_decision_latency_seconds",
    "Latency of one fan-out decision pass (host or device)",
    ["backend"],
    buckets=(0.0001, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.033, 0.1),
    registry=registry,
)
log_events = Counter("logs", "Warn+ log records", ["level"], registry=registry)

# TPU decision plane (new).
tpu_step_latency = Histogram(
    "tpu_spatial_step_seconds",
    "Device AOI/fan-out step latency incl. transfers",
    buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.033, 0.1),
    registry=registry,
)
tpu_entities = Gauge("tpu_entities", "Entities resident on device", registry=registry)
tpu_cell_overflow = Gauge(
    "tpu_cell_overflow",
    "Entities whose cells-plane redistribution bucket was full last tick "
    "(re-offered next tick)",
    registry=registry,
)
tpu_cell_overflow_total = Counter(
    "tpu_cell_overflow_entities",
    "Cumulative entities whose cells-plane redistribution bucket was full "
    "(each was re-offered the next tick; the gauge above is the last-tick "
    "snapshot, this counter is the soak-visible total)",
    registry=registry,
)
tpu_capacity_shed = Counter(
    "tpu_capacity_shed",
    "Device-plane registrations shed to the host path at capacity",
    ["table"],
    registry=registry,
)
handover_count = Counter(
    "handovers",
    "Cross-cell entity handovers orchestrated",
    registry=registry,
)
# Robustness plane (chaos + recovery + sidecar hardening).
chaos_faults = Counter(
    "chaos_faults",
    "Faults injected by the chaos layer (only moves while a scenario is "
    "armed; see channeld_tpu.chaos)",
    ["point"],
    registry=registry,
)
connection_recovered = Counter(
    "connection_recovered",
    "Recoverable server connections that reclaimed their previous id",
    registry=registry,
)
recover_handles_evicted = Counter(
    "recover_handles_evicted",
    "Recovery handles evicted at the table cap (oldest-first)",
    registry=registry,
)
sidecar_call_retries = Counter(
    "sidecar_call_retries",
    "gRPC sidecar calls retried after a transient failure",
    ["method"],
    registry=registry,
)

# Failover plane (core/failover.py; doc/failover.md).
ownerless_drops = Counter(
    "ownerless_drops",
    "Updates dropped because the target channel has no owner connection "
    "(previously only a rate-limited warn log); a sustained non-zero rate "
    "on SPATIAL/ENTITY channels means a dead server's cells were never "
    "re-hosted",
    ["channel_type"],
    registry=registry,
)
server_lost = Counter(
    "server_lost",
    "Recoverable server connections declared dead for good (recovery "
    "window expired or handle evicted); one ServerLostEvent fires per "
    "increment",
    registry=registry,
)
failover_rehost = Counter(
    "failover_rehost",
    "Orphaned spatial cells re-hosted onto surviving servers after a "
    "permanent server loss",
    registry=registry,
)
failover_rehost_ms = Histogram(
    "failover_rehost_ms",
    "Duration of one failover pass (ServerLostEvent -> every orphaned "
    "cell re-hosted and every orphaned entity channel re-pointed), "
    "milliseconds",
    buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 500.0),
    registry=registry,
)
handover_journal = Counter(
    "handover_journal",
    "Transactional handover-journal records by terminal state "
    "(prepared == committed + aborted once the gateway quiesces; the "
    "python-side ledger in core/failover.py must match exactly)",
    ["state"],
    registry=registry,
)

# Live spatial load balancer (spatial/balancer.py; doc/balancer.md).
spatial_cell_entities = Gauge(
    "spatial_cell_entities",
    "Entities resident in one spatial cell's authoritative data "
    "(sampled once per GLOBAL tick by the balancer's load pass)",
    ["cell"],
    registry=registry,
)
spatial_cell_crossings = Counter(
    "spatial_cell_crossings",
    "Entity handovers orchestrated touching one spatial cell "
    "(direction=out: the cell was the crossing's src; direction=in: its "
    "dst) — the balancer's crossing-rate signal, fed from the tick "
    "loop's handover orchestration",
    ["cell", "direction"],
    registry=registry,
)
balancer_migrations = Counter(
    "balancer_migrations",
    "Planned live-cell migrations by terminal result (committed: owner "
    "flipped, zero loss; aborted: deterministic rollback to the old "
    "owner — dst died, drain timed out, overload outranked, or the "
    "world changed underneath; vetoed: never planned because the "
    "destination or the gateway sat at overload L2+; python ledger in "
    "spatial/balancer.py must match exactly)",
    ["result"],
    registry=registry,
)
balancer_migration_ms = Histogram(
    "balancer_migration_ms",
    "Duration of one planned cell migration, freeze -> commit/abort, "
    "milliseconds (includes the crossing-drain window)",
    buckets=(5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 5000.0),
    registry=registry,
)
balancer_imbalance = Gauge(
    "balancer_imbalance",
    "Per-server load imbalance (max/mean of the entity+crossing+bytes+"
    "pressure fold; 1.0 == perfectly even; the balancer plans a "
    "migration when this holds above the enter threshold)",
    registry=registry,
)

# Adaptive partitioning plane (spatial/partition.py; doc/partitioning.md).
spatial_cell_depth = Gauge(
    "spatial_cell_depth",
    "Quadtree depth of one live leaf cell (0 == base grid; published "
    "for every live leaf each governor evaluation, zeroed when the "
    "leaf is split away or merged back)",
    ["cell"],
    registry=registry,
)
partition_ops = Counter(
    "partition_ops",
    "Adaptive-partitioning geometry operations by terminal result "
    "(op=split|merge; result=committed: geometry epoch advanced, "
    "entities repartitioned zero-loss; aborted: deterministic rollback "
    "— drain timeout, owner loss, or overload outranked; vetoed: never "
    "planned because the overload ladder sat at L2+ or the depth/"
    "in-flight guards refused; python ledger in spatial/partition.py "
    "must match exactly)",
    ["op", "result"],
    registry=registry,
)
partition_geometry_epoch = Gauge(
    "partition_geometry_epoch",
    "Monotonic cell-geometry epoch (bumps on every committed split/"
    "merge and every adopted remote geometry; 0 == boot static grid)",
    registry=registry,
)
partition_device_rebuilds = Counter(
    "partition_device_rebuilds",
    "Device micro-grid rebuilds triggered by geometry epochs whose max "
    "active depth changed (result=verified: rebuilt arrays bit-identical "
    "to the host shadow; mismatch: verify_device_state found divergence "
    "— flight recorder force-dumps)",
    ["result"],
    registry=registry,
)

# Cross-gateway federation plane (channeld_tpu/federation;
# doc/federation.md).
federation_handover = Counter(
    "federation_handover",
    "Cross-gateway handover batches by terminal result. Initiator side: "
    "committed (remote ack, src copy torn down), aborted (trunk loss / "
    "timeout / remote refusal — entities restored to the src cell), "
    "refused (the abort was a remote L3 ServerBusy refusal; also counted "
    "in aborted's restore path ledger). Receiver side: applied (entities "
    "adopted into the local shard), refused_remote (local L3 refused the "
    "prepare), reconciled (an applied batch purged after the initiator's "
    "abort notice — source-wins). The python ledger in "
    "federation/plane.py must match exactly",
    ["result"],
    registry=registry,
)
trunk_msgs = Counter(
    "trunk_msgs",
    "Messages crossing gateway<->gateway trunk links (direction=out "
    "counts post-chaos egress, i.e. frames actually written)",
    ["direction"],
    registry=registry,
)
redirects = Counter(
    "redirects",
    "ClientRedirectMessages issued (one per client steered to the "
    "gateway now hosting its interest anchor; staged recovery handle "
    "confirmed by the destination before each send; the python ledger "
    "in federation/plane.py must match exactly)",
    registry=registry,
)
trunk_rtt_ms = Histogram(
    "trunk_rtt_ms",
    "Trunk heartbeat round-trip time, milliseconds",
    buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 500.0),
    registry=registry,
)

# Global control plane (federation/control.py; doc/global_control.md).
global_migrations = Counter(
    "global_migrations",
    "Leader-planned cross-gateway shard migrations by result "
    "(planned: a plan was opened — every plan also lands exactly one "
    "terminal committed/aborted/refused, so sum terminal labels, not "
    "the whole family; committed: the cell's residents drained to the "
    "destination "
    "gateway over the trunk and the source copy was torn down; "
    "aborted: the drain never completed — trunk loss, deadline, or the "
    "world changed — and the directory override reverted to the "
    "source; refused: the destination refused the drain at overload "
    "L3; vetoed: never planned because the overload ladder sat at L2+ "
    "on either end. Counted on the LEADER that owns the plan; the "
    "python ledger in federation/control.py must match exactly)",
    ["result"],
    registry=registry,
)
gateway_adoptions = Counter(
    "gateway_adoptions",
    "Dead gateways whose shard this gateway adopted (cell channels "
    "recreated from the trunk-replicated epoch snapshot, in-flight "
    "journal records replayed source-wins, staged recovery handles "
    "re-staged so redirected clients resume without re-auth); the "
    "python ledger in federation/control.py must match exactly",
    registry=registry,
)
gateway_deaths = Counter(
    "gateway_deaths",
    "Gateway-death declarations processed on this gateway (the leader "
    "declares after global_death_miss_epochs of trunk silence; every "
    "survivor counts the TrunkGatewayDeadMessage it acted on)",
    registry=registry,
)
global_imbalance = Gauge(
    "global_imbalance",
    "Fleet-level per-gateway load imbalance (max/mean of the "
    "entities+crossings+pressure fold over every live gateway's "
    "exported load vector; 1.0 == perfectly even; leader-computed)",
    registry=registry,
)
shard_replica_entities = Gauge(
    "shard_replica_entities",
    "Entities held in trunk-replicated peer-shard snapshots on this "
    "gateway (the adoption bootstrap material; refreshed every control "
    "epoch per live peer)",
    registry=registry,
)

# Device supervision & in-process engine recovery (core/device_guard.py;
# doc/device_recovery.md).
device_state = Gauge(
    "device_state",
    "Device-engine supervision state (0 active, 1 degraded: transient "
    "step failure retrying with backoff, 2 rebuilding: fatal failure, "
    "in-process rebuild from the host shadow in progress, 3 failed: "
    "the rebuild itself failed, retrying on a backoff). Anything "
    "non-zero means device-dependent work is held and the overload "
    "ladder is pinned to L2+",
    registry=registry,
)
device_recoveries = Counter(
    "device_recoveries",
    "Device-engine recoveries completed, by the failure cause that "
    "triggered them (transient: a retried step succeeded without a "
    "rebuild; step_error: retries exhausted, engine rebuilt; hang: the "
    "watchdog deadline expired, engine rebuilt; corruption: the "
    "readback sentinel caught impossible values, engine rebuilt). The "
    "python ledger in core/device_guard.py must match exactly",
    ["cause"],
    registry=registry,
)
device_step_failures = Counter(
    "device_step_failures",
    "Guarded device-step failures observed, by cause (step_error / "
    "hang / corruption / rebuild_fail); every transient retry counts, "
    "so this moves faster than device_recoveries_total",
    ["cause"],
    registry=registry,
)
device_rebuild_ms = Histogram(
    "device_rebuild_ms",
    "Duration of one in-process engine rebuild (host-shadow re-seed + "
    "warmup + bit-identical verification), milliseconds",
    buckets=(5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
             5000.0),
    registry=registry,
)

# Durable persistence plane (core/wal.py; doc/persistence.md).
wal_records = Counter(
    "wal_records",
    "Write-ahead journal records appended, by kind (channel_state: "
    "coalesced per-tick channel images; channel_removed: tombstones; "
    "journal: handover prepare/commit/abort transitions; batch / "
    "batch_done / applied: remote-batch lifecycle; flip: placement-"
    "ledger moves; staged_handle / directory / blacklist: the non-"
    "channel durable state). The python ledger in core/wal.py "
    "(record_counts) must match exactly",
    ["kind"],
    registry=registry,
)
wal_replayed = Counter(
    "wal_replayed",
    "Write-ahead journal records applied by boot replay, by kind (the "
    "restart-side half of the wal_records double entry; torn-tail "
    "records truncated at the first bad CRC are never counted). The "
    "python ledger in core/wal.py (replay_counts) must match exactly",
    ["kind"],
    registry=registry,
)
wal_fsync_ms = Histogram(
    "wal_fsync_ms",
    "Duration of one WAL fsync batch on the off-thread writer "
    "(append() itself never blocks the tick path; this is the "
    "durability interval — RPO is one of these batches), milliseconds",
    buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 500.0),
    registry=registry,
)
resurrection = Counter(
    "resurrection",
    "Fleet resurrection-protocol outcomes (announced: a crash-restarted "
    "gateway sent its trunk hello; yielded: it learned its shard was "
    "adopted while down and handed the adopter its missing WAL-"
    "recovered entities; reclaimed: death was never declared and it "
    "kept its shard; unresolved: no peer answered by the restart "
    "deadline, ordinary zombie evacuation took over; peer_yielded / "
    "peer_reclaimed: the receiving "
    "side's count of each reply it sent). The python ledger in "
    "federation/control.py (resurrections) must match exactly",
    ["outcome"],
    registry=registry,
)
snapshot_writes = Counter(
    "snapshot_writes",
    "Periodic-snapshot loop outcomes (written: state changed and an "
    "fsync-then-rename write landed; skipped: the packed state hashed "
    "identical to the previous write — no disk traffic; failed: the "
    "write raised and will retry next interval)",
    ["result"],
    registry=registry,
)
snapshot_bytes = Gauge(
    "snapshot_bytes",
    "Serialized size of the last written gateway snapshot",
    registry=registry,
)
snapshot_ms = Histogram(
    "snapshot_ms",
    "Duration of one periodic snapshot cycle (pack + hash, plus the "
    "off-thread fsync'd write when the state changed), milliseconds",
    buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 500.0),
    registry=registry,
)

# Overload-control plane (core/overload.py; doc/overload.md).
overload_level = Gauge(
    "overload_level",
    "Current degradation-ladder level (0 normal .. 3 admission control)",
    registry=registry,
)
overload_pressure = Gauge(
    "overload_pressure",
    "Smoothed overload pressure (1.0 == saturated on the worst signal)",
    registry=registry,
)
overload_sheds = Counter(
    "overload_sheds",
    "Work shed by the overload governor (update_priority: low-priority "
    "channel updates withheld; handover_fanout: redundant handover "
    "payloads to already-subscribed dst clients skipped; "
    "handover_defer: crossings re-offered next tick; "
    "follow_interest_defer: follower-interest passes skipped; "
    "sim_cadence_defer: sim passes skipped at L2+ — the agent "
    "population halves its cadence before human traffic degrades "
    "(counted in agents held still); "
    "admission_connection / admission_subscription: L3 refusals with a "
    "ServerBusyMessage; admission_accept: raw CLIENT accepts refused at "
    "the socket past the unauthenticated-backlog headroom. The python "
    "ledger in core/overload.py (shed_counts) must match exactly)",
    ["reason"],
    registry=registry,
)
# Adversarial edge plane (core/edge.py; doc/edge_hardening.md). Every
# counter here is double-entry: the python ledger in core/edge.py
# (EdgeLedgers) must match exactly, and the abuse soak asserts it on a
# live gateway.
conn_quarantine = Counter(
    "conn_quarantine",
    "Connections quarantined by the edge plane (slow_consumer: egress "
    "held at the high watermark past the grace window even after "
    "drop-to-full-resync; ingress_flood: sustained frame-rate cap "
    "violations). Quarantine is per-peer and ends in a structured "
    "disconnect; global load shedding stays with the overload ladder. "
    "The python ledger in core/edge.py (quarantine_counts) must match "
    "exactly",
    ["reason"],
    registry=registry,
)
malformed_frames = Counter(
    "malformed_frames",
    "Inbound wire violations, counted at the stage that rejected them "
    "(framing: bad magic/length/compression tag at the frame decoder; "
    "packet: frame body failed protobuf Packet parse; message: a "
    "MessagePack body failed its template parse or hit an undefined "
    "type). Each is connection-fatal at worst, never gateway-fatal. "
    "The python ledger in core/edge.py (malformed_counts) must match "
    "exactly",
    ["stage"],
    registry=registry,
)
egress_dropped = Counter(
    "egress_dropped",
    "Send-queue entries dropped by the per-connection egress envelope "
    "(queue_msgs: entry cap hit; queue_bytes: byte cap hit; "
    "slow_consumer: queue cleared by the drop-to-full-resync step of "
    "the slow-consumer ladder; quarantine: queue discarded at "
    "quarantine entry). Every cap/ladder drop marks the connection "
    "for full-state resync on its SHED-eligible subscriptions, so a "
    "bounded queue degrades to a coarser cadence, never to silent "
    "state loss. The python ledger in core/edge.py "
    "(egress_drop_counts) must match exactly",
    ["reason"],
    registry=registry,
)
conn_reaped = Counter(
    "conn_reaped",
    "Sockets reaped by edge deadlines (auth_timeout: never completed "
    "the FSM handshake within the auth window — recovery-handle "
    "reconnects exempt; quarantine: the quarantine grace expired and "
    "the peer was disconnected; send_buffer: the MAX_SEND_BUFFER "
    "backstop aborted a peer whose transport backlog outran even the "
    "flush gate). The python ledger in core/edge.py (reap_counts) "
    "must match exactly",
    ["reason"],
    registry=registry,
)
conn_quarantined_num = Gauge(
    "conn_quarantined_num",
    "Connections currently in quarantine (egress frozen, awaiting the "
    "structured disconnect deadline)",
    registry=registry,
)

follower_interest_ms = Histogram(
    "follower_interest_ms",
    "Host cost of one _apply_follow_interests pass, milliseconds "
    "(the previously-unmeasured share of the GLOBAL tick budget)",
    buckets=(0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 33.0, 100.0),
    registry=registry,
)

# Standing-query plane (spatial/queryplane.py; doc/query_engine.md).
# Every counter below has a python-side double-entry ledger on the
# plane (QueryPlane.ledgers) that must match exactly — the soak/bench
# invariant gates compare the two.
standing_queries = Gauge(
    "standing_queries",
    "Live standing-query registrations on the device query plane "
    "(scope: follow = entity-follow AOI, client = UpdateSpatialInterest "
    "query rows, sensor = server-facing sensor API)",
    ["scope"],
    registry=registry,
)
query_rows_changed = Counter(
    "query_rows_changed_total",
    "Changed (query, cell, dist) rows consumed from the per-tick "
    "device diff — the plane's entire host workload is O(this), "
    "not O(standing queries)",
    registry=registry,
)
query_pass_ms = Histogram(
    "query_pass_ms",
    "Host cost of one standing-query plane pass (consume the changed "
    "rows + apply pending sub/unsub diffs), milliseconds",
    buckets=(0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 33.0, 100.0),
    registry=registry,
)
query_plane_transfers = Counter(
    "query_plane_transfers_total",
    "Changed-rows blobs consumed — by design exactly ONE device->host "
    "transfer per tick however many standing queries exist (the bench "
    "gate divides this by ticks and demands 1.0)",
    registry=registry,
)
query_full_resyncs = Counter(
    "query_full_resyncs_total",
    "Query-plane mirror full resyncs: the engine's query epoch moved "
    "(device-guard rebuild or geometry epoch threw the diff baseline "
    "away), so every registered query re-applies from scratch",
    registry=registry,
)
query_malformed = Counter(
    "query_malformed_total",
    "UpdateSpatialInterest messages rejected before touching any "
    "query table (field: which validation tripped — hostile NaN/inf "
    "centers, negative radius/angle, oversize spot lists)",
    ["field"],
    registry=registry,
)

# Simulation plane (channeld_tpu/sim; doc/simulation.md). Every
# counter below is double-entry: the python ledger on the plane
# (SimPlane.ledgers) or engine (sim_rebuild_counts) must match exactly
# — the sim soak/bench invariant gates compare the two.
sim_agents_num = Gauge(
    "sim_agents_num",
    "Simulated agents currently registered in the engine's entity "
    "arrays (they ARE ordinary entities; this gauge is the sim-plane "
    "slice of entity_num)",
    registry=registry,
)
sim_ticks = Counter(
    "sim_ticks_total",
    "Sim passes actually stepped on device (cadence skips and overload "
    "deferrals don't count; the counter-based RNG cursor advances "
    "exactly once per increment, which is the replayability contract)",
    registry=registry,
)
sim_census_transfers = Counter(
    "sim_census_transfers_total",
    "Census batches fetched device->host — by design the sim plane's "
    "ONLY device readback, at census cadence, never per tick (the "
    "bench gate demands zero additional per-tick transfers vs a "
    "no-sim tick; same contract as query_plane_transfers_total)",
    registry=registry,
)
sim_device_rebuilds = Counter(
    "sim_device_rebuilds",
    "Verifications of the rebuilt agent kinematic arrays against the "
    "host shadow (result=verified: bit-identical; mismatch: divergence "
    "found). Fires on every verify_device_state over a live sim plane "
    "— device-guard recovery and geometry-epoch rebuilds both land "
    "here. The engine ledger (sim_rebuild_counts) must match exactly",
    ["result"],
    registry=registry,
)
sim_pass_ms = Histogram(
    "sim_pass_ms",
    "Host cost of one sim-plane pass (census absorb + authority "
    "commit when due; ~0 on non-census ticks), milliseconds",
    buckets=(0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 33.0, 100.0),
    registry=registry,
)

# Fleet health plane: end-to-end delivery SLOs (core/slo.py;
# doc/observability.md). The bucket edges are shared with the SLO
# plane's python-side tally (slo.delivery_quantile — the soak's <5ms
# verdict cross-check), so they live in ONE tuple.
DELIVERY_LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
                            33.0, 100.0, 1000.0)
delivery_latency_ms = Histogram(
    "delivery_latency_ms",
    "End-to-end ingest->fan-out delivery latency, milliseconds: the "
    "monotonic ingest stamp placed on a forwarded update at the "
    "connection read (fast and slow paths) measured against the send "
    "of the fan-out that delivers it. One sample per delivered fan-out "
    "window, stamped with the NEWEST update the window carries — the "
    "gateway-pipeline transit the < 5ms north-star claim is about; "
    "cadence-held staleness is fanout_staleness_ms. path=fast: the "
    "batched native-ingest forward to the GLOBAL owner; path=host / "
    "path=device: the host-scan and device-due ChannelData fan-outs",
    ["channel_type", "path"],
    buckets=DELIVERY_LATENCY_BUCKETS,
    registry=registry,
)
fanout_staleness_ms = Histogram(
    "fanout_staleness_ms",
    "Age of the newest merged-but-undelivered channel state per "
    "subscriber class, milliseconds (sub_class: p0 WRITE/authority, "
    "p1 default-cadence READ, p2 background observers — the overload "
    "ladder's shed order). Sampled once per GLOBAL tick for one "
    "round-robin channel with live data (bounded cost; core/slo.py)",
    ["channel_type", "sub_class"],
    buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0, 5000.0),
    registry=registry,
)
slo_burn_rate = Gauge(
    "slo_burn_rate",
    "Multi-window SLO error-budget burn rate (1.0 == consuming the "
    "budget exactly as fast as the objective allows; core/slo.py "
    "evaluates each declared SLO's bad-event fraction over every "
    "configured window each GLOBAL tick)",
    ["slo", "window"],
    registry=registry,
)
slo_breaches = Counter(
    "slo_breaches",
    "SLO burn-rate alarm firings by SLO (a window's burn rate crossed "
    "its alarm threshold — counted once per rising edge per window, "
    "and each breach freezes a flight-recorder slo_breach anomaly "
    "dump so the violating tick timeline ships with the alarm). The "
    "python ledger in core/slo.py (breach_counts) must match exactly",
    ["slo"],
    registry=registry,
)

# Flight recorder / tick-timeline tracing (core/tracing.py;
# doc/observability.md).
tick_stage_ms = Histogram(
    "tick_stage_ms",
    "Host cost of one named per-tick stage, milliseconds (ingest: "
    "deferred-read drain; stash_retry: backpressure re-dispatch; "
    "messages: channel queue drain incl. FSM dispatch; fanout: "
    "ChannelData fan-out encode/send; device_step: batched engine "
    "dispatch+step; readback: device->host interest-mask transfers; "
    "follow_interests: the full follower pass; handover: crossing "
    "orchestration; overload: governor update; trunk: trunk ingress "
    "dispatch). The flight recorder observes these whether or not span "
    "recording is enabled",
    ["stage"],
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 33.0, 100.0),
    registry=registry,
)
trace_dumps = Counter(
    "trace_dumps",
    "Anomaly-triggered flight-recorder freezes by trigger (tick_budget: "
    "a tick overran its interval; overload_transition: the degradation "
    "ladder moved; handover_abort: a cross-gateway batch aborted; "
    "migration_abort: a balancer cell migration rolled back; "
    "failover_epoch: a dead server's cells were re-hosted; "
    "device_failure: the device engine failed fatally and is "
    "rebuilding in-process; slo_breach: an SLO burn-rate alarm fired "
    "(core/slo.py); "
    "manual/sigusr2/shutdown: explicit dump_trace calls). Anomaly "
    "triggers count even when the dump itself was suppressed by the "
    "cooldown; a disabled recorder (-trace false) counts nothing",
    ["trigger"],
    registry=registry,
)
follower_readbacks = Counter(
    "follower_readbacks",
    "Device->host interest-mask transfers performed by "
    "_apply_follow_interests — one BATCHED transfer per pass covering "
    "every AOI follower (engine.interested_cells_batch). Before the "
    "batching this counted one transfer per follower per pass "
    "(ROADMAP item 1's measured bottleneck, ~330us each; "
    "BENCH_RESULTS.md round 12 has the before/after)",
    registry=registry,
)

# The goroutine-count analog: live asyncio tasks (one per channel tick,
# listener, pump). Updated by the server's heartbeat (serve loops) and by
# any caller of sample_runtime().
asyncio_tasks = Gauge(
    "asyncio_tasks", "Live asyncio tasks", registry=registry
)

# Python process + GC runtime families — the analog of the reference
# dashboard's go_memstats/go_gc/goroutines panels (grafana/dashboard.json).
try:  # pragma: no cover - collector support is environment-dependent
    from prometheus_client.gc_collector import GCCollector
    from prometheus_client.process_collector import ProcessCollector

    ProcessCollector(registry=registry)
    GCCollector(registry=registry)
except Exception:
    pass


def sample_runtime() -> None:
    """Refresh point-in-time runtime gauges (asyncio task count)."""
    import asyncio

    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        return
    asyncio_tasks.set(len(asyncio.all_tasks(loop)))


def serve_metrics(port: int = 8080) -> None:
    """Expose /metrics (reference serves this from main, cmd/main.go:50)."""
    start_http_server(port, registry=registry)
