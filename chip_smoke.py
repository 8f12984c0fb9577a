#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --gateway 50000 30   # phase 6a alone, at another size
    python3 chip_smoke.py --mesh               # phase 7 alone
    python3 chip_smoke.py --engine-adapter 10000 12   # phase 8a alone, at another size
    python3 chip_smoke.py --recovery 10000 30  # phase 10a alone, at another size
    python3 chip_smoke.py --elastic 1500 120   # phases 11a and 11b alone, at another size
    python3 chip_smoke.py --soaks 1000 4096    # phase 12 alone: sim agents, sensor-soak entities
    python3 chip_smoke.py --trace-obs          # phases 1-3, then phase 13 alone
    python3 chip_smoke.py --chaos-overload     # phases 1-3, then phase 14 alone
    python3 chip_smoke.py --fleet              # phases 1-3, then phase 15 alone
    python3 chip_smoke.py --crash              # phases 1-3, then phase 16 alone
    python3 chip_smoke.py --fleet-live         # phases 1-3, 13b and 13d, then phase 17
    python3 chip_smoke.py --edge               # phases 1-3, then phase 18
    python3 chip_smoke.py --failover-balance   # phases 1-3, then phase 19
    python3 chip_smoke.py --graft-entry        # phases 1-3, then phase 20

The script starts its own children (none needs a card but a ``--cpu-leg``
child's CUDA sync counters; each loads neither JAX nor the JAX package). The
host-grid roles live in ``chip_host.py`` and start before this script imports
numpy or torch; they load neither:

    --fed-child CONFIG REPORT                  # 15b's gateway "b"
    --crash-child CONFIG REPORT STATE_DIR SEED # 16b's gateway "b", SIGKILLed twice
    --live-child ROLE GW CONFIG REPORT PARAMS  # phase 17's gateways: ROLE trace (17a's
                                               # "b"), obs (17b's "b") or global (17c's
                                               # "b" and "c"); PARAMS the role's JSON
    --edge-child REPORT                        # phase 18's abuse soak, whole
    --cpu-leg PHASE SCRATCH                    # the CPU leg of 6a, 10a, 11a, 11b, 12b,
                                               # 14a, 16a or 19a at the size pickled in
                                               # SCRATCH
    --sim-child WAL AGENTS CENSUS_EVERY DEVICE # 12a's kill leg
    --sticky-child                             # 10b's sticky CUDA error

A child gateway is driven over its stdin, one JSON command a line
(``{"cmd": "report"}``; each answers ``OK <cmd>`` on stdout): a ``--fed-child``
takes force_l3, clear_l3, herd_back, quiesce, report, exit; a
``--crash-child`` spawn, herd_to, flush_wal, arm_torn, quiesce, report, exit;
a ``--live-child`` report and exit, and as ``global`` also spawn, herd_to and
quiesce. Each host-grid role prints ``READY`` with a JSON of its boot's parts
and the modules of torch, of JAX or of the JAX package it loaded (none).

Needs one CUDA card, nvcc, and the ``channeld_tpu_torch`` package beside
this file; imports nothing of JAX or of ``channeld_tpu``. Phases (each
prints one line; any failure exits non-zero before the final line):

1. device: the card's name and ``nvidia-smi`` name/power limit;
2. build: both kernels from ``channeld_tpu_torch/ops/csrc`` (one nvcc
   each, started together), with the build time and ptxas's report;
3. kernel parity on the card, exact, each kernel against its plain
   PyTorch version on the same inputs: the assign+count kernel (K1) at
   131,072 slots on the 15x15 grid (shared-memory histograms), on a
   crowd (half the slots in one cell) and at 1,048,576 slots, and at
   131,072 on a 256x256 grid (global atomics), uniform and crowded,
   with NaN, ±inf, 1e20, invalid and cell-boundary positions; the AOI
   kernel (K2) at 4,096 mixed queries on 15x15 and 1,024 on 256x256,
   with zero, negative, NaN and inf extents, and on blocks of cell ids.
   Times: the kernel alone (bare C launches queued back to back, CUDA
   events, beside torch.profiler's figure), the wrapper call, the plain
   version, the roofline bound, and K2's write floor (filling its
   1,024 x 65,536 outputs). It also checks that a K1 call runs one
   kernel and no zero-fill;
4. the main path at deployment size: the sidecar's decision pass
   (``SpatialDecisionServicer.install``/``decide``, the code behind
   Configure/Step) on ``cuda`` at the sidecar's default capacities
   (1<<17 entity slots, 1<<12 query slots, 1<<16 subscription slots,
   4,096 handover rows) on the 15x15 grid of 2,000 m cells from
   (-15000, -15000) (config/spatial_tpu_benchmark.json), with 100,000
   moving entities, 4,096 standing queries of every kind and ~16K
   subscriptions at 33-200 ms, for 30 steps of 33 ms, one of which
   overflows the handover budget. The same seeded requests go through a
   CPU servicer (the plain path); every step's handovers, cell counts,
   interest rows and due ids must be equal, and each kernel must have
   launched once per step. Prints the median and p99 step time;
5. the sim world at full width: scripts/sim_bench.py's deployment (the
   64x64 grid of 100 m cells, 1<<17 entity slots, 4,096 handover rows,
   100,000 agents stepped on the device every tick, seed 20) with the
   standing-query plane armed at the gateway defaults (4,096 query
   slots, 8,192 changed rows per tick) carrying 1,024 follower spheres
   and 3,072 static box/cone/spots sensors, 4,096 subscriptions, and a
   flee mask set before tick 0 and changed mid-run; 30 ticks, the
   census on the last, then rebuild + verify, corrupt + rebuild +
   verify, and a swap to a 32x32 grid of 200 m cells + verify + one
   tick. Checks: every tick equal to a CPU run of the port (handovers,
   counts, due ids, changed query rows, FSM states, and every sim column
   bit for bit); a second card run bit-identical; no more device-to-host
   reads on a steady tick with the sim pass than without it, and exactly
   four more on the census tick; every verify clean; K1 and K2 once per
   tick, and each equal to its plain version at this path's shapes.
   Prints the sim pass's cost per tick, the diff's time, census +
   rebuild + verify time and the device idle share of a tick;
6. the gateway (``python -m channeld_tpu_torch``'s main path):
   a. lockstep: scripts/fanout_bench.py's config4
      (config/spatial_tpu_benchmark.json: 15x15 cells of 2,000 m, 3x3
      spatial servers and the master) with 6,000 moving entity channels
      (cut from the bench's 50,000; ``--gateway ENTITIES TICKS`` runs
      this phase alone at any size), a storm of entities // 8 twice,
      the standing-query plane and the sim plane at the gateway
      defaults, 256 followers, 1,024 sensors and subscriptions at
      33-200 ms, the device guard on, 12 GLOBAL ticks on a fixed clock,
      in-process with stub connections, on ``cuda`` and, at the same
      size, on the CPU in a ``--cpu-leg`` child started at phase 4.
      Every tick's handovers, spatial entity tables, every
      connection's outbound stream, changed query rows and sim columns
      must be equal (the first difference is printed); 2 device reads
      per steady tick and 4 more on a census tick; K1 and K2 once per
      tick, and exact on the live tensors. Prints tick, GLOBAL tick,
      guarded device step and host share per tick on both legs, the
      fan-out decision p99 and the device idle share of 5 profiled
      ticks;
   b. live: ``python -m channeld_tpu_torch`` as a child on ``cuda``,
      driven over loopback TCP by the port's client: a master and 9
      servers claim the world, a server sets a client's follow interest
      on an entity that then crosses from one server's cell into
      another's; both servers receive the handover and the client its
      interest update; SIGTERM must end it with exit code 0;
   c. threads: two engines ticked from two threads on one card keep
      K1's counts exact against the plain version;
7. the multi-device planes (``channeld_tpu_torch/parallel``), on 8
   shards over the cards present (all on one card when there is one,
   which it prints), each held against the same mesh on the CPU, every
   int and bool output equal on every tick (each mismatch printed):
   a. the steps at the sidecar's width (1<<17 slots, 4,096 queries of
      every kind with spots, 65,536 subscriptions, 4,096 handover rows,
      BENCH_GRID): the entity-sharded step on 8 shards and on a (2, 4)
      mesh and the cells serving step on 8 shards with a bucket the
      storm overflows, 30 ticks of 100,000 moving entities with churn,
      a burst past one shard's 512 rows and a storm; also against the
      single-device step on the card fed the same inputs (every output
      on ticks without overflow); K1 once per shard per tick, K2 once
      (entities) or once per shard (cells), each exact against its
      plain version on the live tensors; step times by host clock and
      CUDA events beside the single-device step's, 5 profiled ticks;
      then the halo plane on SIM_GRID (100,000 entities, 8 rows per
      shard) against the dense computation;
   b. ``SpatialEngine(mesh=...)`` in both shardings at the same width
      with the standing-query plane on, 30 ticks through the engine API
      against the meshed engine on the CPU and the unmeshed engine on
      the card (counts only on ticks without bucket overflow); 2 reads
      per steady tick; rebuild, corrupt + rebuild and ``apply_grid``,
      each verified clean;
   c. the gateway (phase 6a's world, cut to 5,000 entities x 12 ticks)
      with ``Sharding: "cells"``, ``MeshDevices`` = min(cards, 8) and a
      ``CellBucket`` that overflows, card leg against CPU leg tick for
      tick (handovers, tables, outbound streams, changed rows,
      undelivered slots, the ``tpu_cell_overflow_total`` delta);
8. the engines' paths through the gateway, each leg on the card
   against a CPU leg under a fixed clock, every tick equal:
   a. the engine adapter (``models/engine_adapter.py``) on phase 6a's
      config4 at the gateway's default capacities: 5,000 objects
      (every 16th a non-spatial game-mode actor) spawned by SPAWN (103)
      with locations over the grid, moved +-60 m per tick by entity
      channel updates, a storm of an eighth into one cell and back, a
      tenth destroyed by DESTROY (104) at the middle tick and spawned
      again, 256 followers, 256 clients with 4 subscriptions at 33-200
      ms; 12 ticks (``--engine-adapter OBJECTS TICKS`` runs it alone).
      Digests of handovers, every spatial channel's entity table, the
      adapter's recovery table and every outbound stream; K1 and K2 on
      every card tick; 2 reads per steady tick; 5 profiled ticks;
   b. the same traffic in the Unreal SDK's types
      (``compat/unreal.py``: unrealpb.FVector spawn locations, Z-up
      swapped to Y-up), 1,000 objects x 6 ticks;
   c. ``python -m channeld_tpu_torch -imports channeld_tpu_torch.compat``
      as a child on ``cuda``; ``python -m channeld_tpu_torch.replay run``
      replays examples/sessions/chat_demo.cpr with 8 connections against
      it: exit 0, every connection authenticated, every packet sent,
      ``device_state`` 0 on /metrics afterwards;
   and one line saying whether the port's native codec was built from
   its ``codec.cc`` and taken by the framing;
9. if grpc and protobuf are installed, one real sidecar round trip on
   ``cuda`` (otherwise says it was not run);
10. the recovery path (``core/device_guard.py`` on the card):
   a. lockstep: phase 6a's world cut to 3,000 entities x 30 ticks, the
      device guard's deadline at the gateway's default 2 s, armed on a
      fixed clock with scripts/device_soak.py's schedule (two transient
      step errors, a 3,500 ms hang whose first rebuild fails, a silent
      corruption; each on a storm tick), on ``cuda`` and on the CPU in a
      ``--cpu-leg`` child started at phase 8: every tick equal (handovers, tables, outbound streams,
      changed rows, sim columns, the guard's state and ledgers, the
      ladder, whether the tick was served); on both legs recoveries
      transient, hang and corruption once each, equal to the metrics,
      every rebuild verified clean, zero entities lost or duplicated,
      the ladder pinned at L2 through each outage and released, a
      snapshot on each fatal and each recovery that reads back; K1 and
      K2 exact on the first tick after each rebuild. Prints each
      outage's unserved ticks, each rebuild's host time and the guarded
      step before and after;
   b. real faults on the card: a ``torch.cuda._sleep`` of ~3.5 s queued
      on the engine's stream inside the guarded window, after the tick's
      kernels (the readback overruns the 2 s deadline) and before them
      (the tick's upload waits): a hang each, healed by a rebuild that
      ran behind the wedge, the zombie fenced off, K1 exact after; and a
      child (``--sticky-child``) whose engine step hits a real
      device-side assert: the guard FAILED for good, readiness down,
      nothing escaping the loop thread, the error's text printed;
   c. live: ``python -m channeld_tpu_torch`` as a child on ``cuda`` with
      ``-chaos`` (the same schedule on its own clock), ``-snapshot``,
      ``-wal`` and ``-device-deadline 2``: a crossing to both servers
      and the follower after each recovery, the recovery counters,
      ``device_state`` 0 and /readyz 200; SIGKILL, a restart from the
      snapshot and WAL with the census of /introspect unchanged, a
      crossing after it, SIGTERM exit 0;
11. the elastic world (adaptive partitioning, the balancer's migrations
    and failover on the card), on the port's copy of
    scripts/density_soak.py's phases (``elastic_scenario``: warmup,
    pileup into a quarter of one cell, repile into a second cell whose
    owner is dropped on the tick its split starts draining, disperse),
    120 ticks of a fixed 33 ms clock, card leg against CPU leg:
   a. phase 6a's world (config4, the gateway's defaults, the sim plane)
      with 800 entities (cut by the script's time): splits to depth 2
      (15x15 -> 30x30 -> 60x60 on the device), granule migrations, the
      kill (the split aborts, failover re-hosts the cell, the re-planned
      split commits with a ``device.step_hang`` on its commit tick), and
      merges back to 15x15. Every tick equal (handovers, tables, every
      outbound stream and the cell-authority messages apart, the
      geometry epoch and micro grid, the partition, balancer and
      failover ledgers, the journal); every re-grid's device rebuild
      verified with no mismatch; at least one committed split and
      migration, exactly one aborted split, a re-host, the boot geometry
      at the end; zero entities lost or duplicated, the journal
      balanced; K1 and K2 once per engine tick and exact on the live
      tensors after each re-grid (timed at those shapes); 2 reads per
      steady tick before and after each re-grid;
   b. config/spatial_tpu_cells_2x2.json's world on the cells plane at
      MeshDevices = min(cards, 8), 400 entities, a CellBucket the
      pileup overflows and the density soak's dispatch-stall weather:
      the same schedule without the hang, the same checks, K1 and K2
      once per shard per engine tick;
   c. live: ``python -m channeld_tpu_torch`` on that world with
      ``-partition true``, ``-chaos`` and ``-overload false``: a
      committed split, a verified re-grid, a committed migration,
      ``device_state`` 0, the merge back;
12. the device-resident populations under churn and chaos, on the
    port's copies of scripts/sim_soak.py's and scripts/sensor_soak.py's
    worlds and schedules, with the device tables at the gateway's
    defaults (1<<17 entity slots, 4,096 query rows), card leg against
    CPU leg tick for tick on a fixed clock (handovers, cell tables, every
    outbound stream and subscription, changed query rows, sim columns bit
    for bit, the guard and every ledger), each leg held to every
    invariant of its soak; K1 and K2 once on every tick the engine ran
    and never on one the guard held, exact on the live tensors; 2 reads
    per steady tick:
   a. the sim soak: 1,000 agents (the -sim-agents default) and 160
      tracked humans on 4x1 cells of 100 m, a census every 4 passes, the
      guard with a 1 ms backoff; steady 60 ticks, ``sim.stampede`` (every
      agent herded into one cell) 50, ``sim.step_nan`` (a quarter of the
      agent rows rotted on the card; the sentinel catches it on the same
      tick on both legs and the rebuild heals it) 12, a same-grid
      ``apply_grid`` and 12 more; the exact census after each phase; 4
      more reads on a census tick. Then the kill leg: ``--sim-child WAL
      AGENTS CENSUS_EVERY DEVICE`` runs the world on the card journaling
      censuses until it is SIGKILLed after 2; its WAL replayed on the card
      and on the CPU restores the last census's hash bit for bit, the
      agent count and the sim clock. K1 is held to its plain version on
      the stampede's crowd and on the rotted rows;
   b. the sensor soak x16: 4,096 tracked entities on 8x8 cells, 768
      follows, 768 clients (queries through the interest handler) and 384
      sensors, 90 ticks: a tenth of the entities moved each tick, 16
      clients closed and 16 arrived every 7th tick, 16 queries re-issued
      every 11th, a rebuild at 30 and a same-grid epoch at 60; the soak's
      books (one query-plane transfer a tick three ways, rows and resyncs
      equal to their counters, 2 resyncs, the pass observed each tick,
      the scope gauges, the callback, reaped = closed) and every live
      client's subscriptions a superset of its host answer;
13. the trace and obs planes, on the port's copies of
    scripts/trace_soak.py's and scripts/obs_soak.py's phases 1 and 3, on
    their cells world (config/spatial_tpu_cells_2x2.json at MeshDevices =
    min(cards, 8)) with the device tables at the gateway's defaults (1<<17
    entity slots, 4,096 query rows), the query plane and the sim plane
    off, so followers take the legacy path (``interest_rows``, the
    ``readback`` stage):
   a. lockstep: the trace soak's world in-process on a fixed clock whose
      ``time.sleep`` moves the clock (a chaos stall costs its tick exactly
      its stall on both legs): the master and 4 servers, 120 entities
      jittered every tick, a storm of 40 at 30% dispersed at 70%, 16
      clients' forwards a tick, 8 followers, the guard off, the recorder
      on, the soak's chaos with ``every_n`` scaled to 150 ticks; card leg
      against CPU leg, every tick equal (handovers, tables, every outbound
      stream, the span names the recorder holds for the tick, the stage
      counts, ``follower_readbacks_total``, the anomalies, the chaos
      fires); 2 device reads a tick; K1 and K2 once per shard a tick and
      exact on the live tensors; each leg's ``tick_budget`` dumps
      Perfetto-valid with ``device_step`` spans;
   b. live: the trace soak's phase 1 at its own parameters (20 s, 16
      clients at 30 msg/s, 120 entities, 8 followers, a storm of 40, its
      scenario) on an in-process asyncio gateway with TCP listeners on
      loopback and the engine on ``cuda``: every stage of the GLOBAL tick
      measured (count, mean, p50, p99 printed), a Perfetto-valid
      ``tick_budget`` dump, follower readbacks; K1 and K2 once per shard
      on every engine tick;
   c. and e. the trace soak's and the obs soak's overhead phases (the
      recorder, then the SLO plane, on and off tick by tick, 120 x 3, gc
      off) at their own tables (256 slots, 16 query rows) and at the
      gateway's defaults: the four ratios printed against the 3% and 2%
      bars, pass or fail, and the raw span cost; K1 and K2 once a tick,
      exact on the live tensors;
   d. live: the obs soak's phase 1 at its own parameters (steady 15 s,
      breach 12 s, 8 clients, an updater and 4 viewers on a SUBWORLD
      channel) with the guard on and the ops surface on an ephemeral
      port: the steady window's delivery p50 and p99 (the < 5 ms verdict
      printed as measured), the SLO breach and its dump, the ledger equal
      to ``slo_breaches_total``, /healthz, /introspect, /metrics, the
      staleness samples, /readyz 200 -> 503 -> 200 across a FAILED set
      directly (not terminal, F8) and across a wedged WAL, the guard
      ACTIVE at the end; K1 and K2 once per shard on every engine tick.
14. the live chaos soak and the overload ladder, on the port's copies of
    scripts/chaos_soak.py and scripts/overload_soak.py, on their cells
    world (config/spatial_tpu_cells_2x2.json at MeshDevices = min(cards,
    8), CellBucket 6) at the gateway's tables (1<<17 entity slots, 4,096
    query rows), the overload ladder on, the guard, SLO plane, recorder,
    balancer, partitioning, federation and sim plane off:
   a. lockstep: the overload soak's world in-process on the fixed clock
      whose ``time.sleep`` moves it (so a tick's budget utilisation, the
      pressure and every hold of the ladder are the same numbers on both
      legs): 128 entities jittered every tick, storms of 64 every 3 s in
      the window, 16 clients' forwards and 4 observers at 200 ms, the
      query plane on; the soak's scenario armed at tick 0 with a 2 s
      warmup and a 12 s saturation window (every dispatch stalls 90 ms,
      every 6th message 12 ms), then recovery until L0 and 1 s quiet; on
      each of the first 3 ticks at L3 a new client's AUTH through the
      gateway's handler. Card leg against CPU leg (a ``--cpu-leg`` child
      started at phase 13), every tick equal (level, pressure, components,
      transitions, shed ledger, overflow, handovers and the deferred
      crossings, tables, every outbound stream with the ServerBusyMessage
      frames); each leg reaches L3 one step at a
      time, never rises once it descends, ends at L0, sheds low-priority
      updates and defers handovers with a ledger equal to
      ``overload_sheds_total``, and loses no entity; 2 device reads a
      tick; K1 and K2 once per shard a tick and exact on the live tensors
      of the first overflowing tick and the first tick at L2+ in the window;
   b. live: the chaos soak at its acceptance widths (24 clients at 25
      msg/s, 160 entities, storms of 48 every 10 s, all seven fault
      points), 50 s of traffic and 10 s quiesced, on an in-process asyncio
      gateway with TCP listeners on loopback and the engine on ``cuda``:
      every invariant of the soak under its own name; K1 and K2 once per
      shard on every engine tick;
   c. live: the overload soak at its acceptance widths (16 busy-aware
      clients at 20 msg/s, 4 observers, 128 entities, storms of 64 every
      6 s, a 50 ms GLOBAL budget, batch cap 4, down-hold 1 s), warmup 6
      s, saturation 20 s, recovery up to 15 s, quiesce 4 s: every
      invariant of the soak under its own name, the tick p99 bounded at
      each level, the return to L0 within the deadline; K1 and K2 once
      per shard on every engine tick.
15. the fleet: the federation plane and the global control plane over the
    device controller, and scripts/federation_soak.py's live fleet:
   a. lockstep: gateway "a" of scripts/global_soak.py's three-gateway
      world (WORLD_3: 6x4 cells of 50 m in three 2x4 blocks, the soak's
      directory and control-plane settings, "a" the leader) on the device
      controller at the gateway's tables (1<<17 entity slots, 4,096 query
      rows) with the sim plane (64 agents) and the query plane on, the
      guard on, 150 GLOBAL ticks of a fixed 50 ms clock (the control epoch
      every 5 ticks, the plane's timeout sweep every 2), in-process with
      stub connections; the peers b and c are scripted stubs behind tapped
      trunk links, answering through a's own trunk dispatch: 96 entities,
      8 sensors of every kind and 4 followers in a's block; an outbound
      burst of 24 (8 agents) east across x = -50 committed by b (the
      channels and slots gone, the agents left the population); a burst of
      10 b refuses at L3 (restored at the source, parked, re-offered, then
      committed); b's inbound herd of 16 (6 in the agent range: tracked at
      their cells' centres, the agents re-flagged); a burst of 24 whose
      trunk is cut mid-flight (every batch aborted and restored, re-offered
      on trunk up, b's applied copies purged by the abort notices); c's
      shard epochs (14 entities in its cells, 2 in-flight txns, 4 sensor
      rows), its silence, a's death declaration after the miss window, b's
      census claims (2) and a's adoption (c's cells created, its entities
      tracked on the card, its sensor rows on a's query plane, the claimed
      ids not recreated). Card leg against CPU leg, every tick equal
      (handovers, the trunk messages a sent as bytes in order, tables, the
      placement ledger, the engine's slots, cells and counts, the agents
      and sim columns, changed query rows, every ledger, the peers'
      holdings, every outbound stream); on both legs the six events, the
      census across a, b and c (zero lost, zero duplicated), each ledger
      equal to its metric, the journal balanced; 2 device reads a steady
      tick; K1 and K2 once per engine tick, exact on the live tensors after
      the inbound herd and after the adoption;
   b. live: scripts/federation_soak.py's run_fed_soak at
      tests/test_federation.py::test_federation_smoke_soak's parameters
      (32 entities, bursts 8 / 4 / 8 / 6, phase timeout 15 s, quiesce 1.5
      s): gateway "a" in-process on this asyncio loop and gateway "b" a
      ``--fed-child`` process of this script (it loads neither JAX nor the
      JAX package), both on the script's Static2DSpatialController, which
      touches no device by the script's design: every invariant of the
      script under its own name, at least 8 committed and 1 refused,
      exactly 1 redirect, the census with nothing missing or duplicated.
16. the crash soak (``core/wal.py``, ``core/snapshot.py`` and the
    resurrection): a. gateway "b" of scripts/crash_soak.py's world on the
    device controller, killed twice in-process and restarted from its
    snapshot and WAL, card leg against CPU leg tick for tick; b.
    scripts/crash_soak.py's live run with a SIGKILLed ``--crash-child``.
17. the last live fleet paths, each held to its script's invariants under
    their names, every gateway on the scripts' Static2DSpatialController
    (the host grid: no kernel runs, by the scripts' design, and each path
    is checked to launch none), gateway "a" in-process and the others
    ``--live-child`` processes whose boot (Popen to READY) is printed:
   a. scripts/trace_soak.py's phase 2 (bursts 10 + 10, seed 20260803): a
      committed burst whose trace ids stitch a's and b's spans, the trunk
      severed mid-burst for a Perfetto-valid ``handover_abort`` dump, the
      trunk stage measured (with 13b's stages when phase 13 ran);
   b. scripts/obs_soak.py's phase 2 (8 s at a 200 ms epoch, seed
      20260804): b's own metric digest equal to the copy stored on a, and
      every label set of a's /fleet equal to the sum of both digests;
   c. scripts/global_soak.py's three gateways at its defaults (10 entities
      a gateway, a hotspot of 36, a kill burst of 10, 4 committed to c,
      250 ms epochs, death after 4 missed): the hotspot flattened by a
      leader-planned migration, c SIGKILLed mid-burst, its shard adopted,
      the redirected client resumed on a survivor, the census; its 14
      invariants and scripts/check_artifacts.py's bar.
18. the abuse soak (``core/edge.py``, ``core/ddos.py``): scripts/abuse_soak.py's
    run_abuse_soak at AbuseSoakParams(), cut nowhere (attack 14 s, quiesce 4
    s, 8 honest clients at 30 msg/s, 3 slow readers under a 150/s flood of
    8,192 B, 3 malformed-frame sources, 3 connect-flood IPs, auth deadline
    1,200 ms), whole in a ``--edge-child`` process that loads no torch (its
    gateway has no spatial controller, by the script's design, and runs no
    kernel): its 22 invariants under their names and
    scripts/check_artifacts.py's bar; the sessions per attacker class, the
    four edge ledgers beside their metrics, census, delivery and RSS.
19. the failover and balance soaks on the device controller
    (``core/failover.py``, ``spatial/balancer.py``,
    ``core/connection_recovery.py``), on config/spatial_tpu_cells_2x2.json at
    MeshDevices = min(cards, 8) and the gateway's tables:
   a. both scripts' runs in-process on a fixed clock whose ``time.sleep``
      moves it (a master and 4 recoverable server stubs, the scripts' pins,
      knobs and weather, their phases shortened), against a ``--cpu-leg
      19a`` child tick for tick: scripts/failover_soak.py's two kills (the
      first mid-handover burst, the second during the first failover
      epoch) with the probes at an orphaned cell, and
      scripts/balance_soak.py's hotspot migrations and its destination
      killed inside the widened freeze window; every invariant of each
      script on both legs, 2 device reads a tick, K1 and K2 once per shard
      a tick and exact on each kill tick, the first tick after each
      re-host and each migration's resolving tick;
   b. scripts/failover_soak.py's run_failover_soak live through the port
      at FailoverSoakParams() (TCP listeners on loopback, the engine on the
      card), its 19 invariants and check_artifacts' keys;
   c. scripts/balance_soak.py's run_balance_soak live at
      BalanceSoakParams(), the kill mid-migration on, its 16 invariants and
      check_artifacts' keys; K1 and K2 once per shard on every engine tick
      of b and c.
20. ``__graft_entry__.py``'s entry points through the port
    (``channeld_tpu_torch/graft_entry.py``):
   a. ``entry()``'s ``fn`` on its example (256 entities, 16 sphere queries,
      64 subscriptions, 8x8 cells) on the card against the same call on
      the CPU: every output equal exactly, K1 and K2 launched once each,
      each held against its plain version on the step's tensors;
   b. the same at the sidecar's scale (100,000 entities, 4,096 queries,
      65,536 subscriptions, 15x15 cells);
   c. ``dryrun_multichip(8)`` on the card (the cards present, repeated in
      turn to 8 shards when fewer than 8: one card holds all 8): the
      serving engine under the entities, entities-2D and cells shardings
      equal to the single-device engine, the cell-sharded all_to_all
      plane equal to the dense counts, and every tick's decisions equal to
      ``dryrun_multichip(8, device="cpu")``.

The line before the last is a JSON object with one entry per kernel
(times measured in this run at the sidecar path's shapes; bound from
this run's shapes; ``ms`` is the kernel alone by events, ``call_ms`` one
wrapper call; ``launches`` on the sidecar path, ``launches_by_path`` on
each path (the gateway's shapes are the sidecar's), ``sim_path`` the
same figures at the sim world's shapes, ``mesh_path`` at one shard's
shapes of phase 7 with the launches per mesh tick, ``fused_block`` K2's
fused-centre block of the cells plane beside the unfused launch,
``elastic_path``/``elastic_mesh_path`` each kernel at the shapes after
each re-grid of 11a and 11b, ``soak_path`` each at the live tensors of
12a's stampede crowd, rotted rows and last tick and 12b's last tick,
``trace_obs_path`` at 13a's cells shard and 13c's two tables,
``chaos_overload_path`` at 14a's live tensors on its first overflowing
tick and its first tick at L2 or above in the saturation window,
``fleet_path`` at 15a's live tensors after the inbound herd and after the
adoption, ``crash_path`` at 16a's, ``failover_balance_path`` at 19a's
kill, re-host and migration ticks, ``graft_entry_path`` at 20a's and
20b's step; the paths of phases 17 and 18 launch
none, each noted in ``launches_by_path_notes``);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import time

_T_IMPORTS = time.perf_counter()  # a host-grid child reports its imports' time

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from types import SimpleNamespace as NS  # noqa: E402
from typing import Optional  # noqa: E402

if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_host  # noqa: E402
from chip_host import (  # noqa: E402
    CLIENT_FSM, CRASH_BASE, CRASH_XR, CRASH_ZR, GLOBAL_BASE, GLOBAL_XR, GLOBAL_ZR, PHASE2_TRUNK,
    SERVER_FSM, WORLD_3, WORLD_SPATIAL, AbuseSoakParams, CrashSoakParams, FedSim, FedSoakParams,
    GlobalSoakParams, entity_alive, entity_forensics, fed_boot_gateway, fed_config, fed_config3,
    fed_free_ports, fed_local_placement, fed_metric_delta, fed_pins, fed_teardown_gateway,
    fed_trunk_metrics, gateway_modules, global_boot, global_control_report,
    global_settings_hook, obs_fed_settings_hook, persistence_paths,
    persistence_report, reset_gateway, soak_auth, soak_frame, soak_read_frames,
    wal_pre_start_hook, wal_settings_hook)

if __name__ == "__main__" and sys.argv[1:2] and sys.argv[1] in chip_host.ROLES:
    # A host-grid child gateway (15b, 16b, 17, 18): it runs before numpy and
    # torch are imported, and never imports either.
    sys.exit(chip_host.run_role(sys.argv[1:], time.perf_counter() - _T_IMPORTS))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
# Float operations the AOI function needs per (query, cell) pair once its
# per-axis terms are formed: two sums, a root, the scaling, a ceiling
# and the tests (~8); and per (query, column) or (query, row): centre,
# delta, gap, three products and the box test (~12).
AOI_OPS_PER_PAIR = 8
AOI_OPS_PER_AXIS = 12
ASSIGN_OPS_PER_SLOT = 10  # 2 sub, 2 div, 2 floor, 4 compares
BENCH_GRID = dict(offset_x=-15000.0, offset_z=-15000.0, cell_w=2000.0,
                  cell_h=2000.0, cols=15, rows=15)
WIDE_GRID = dict(offset_x=-25600.0, offset_z=-25600.0, cell_w=200.0,
                 cell_h=200.0, cols=256, rows=256)
# Phase 12a's: the sim soak's 4x1 cells of 100 m.
SOAK_GRID = dict(offset_x=0.0, offset_z=0.0, cell_w=100.0, cell_h=100.0, cols=4, rows=1)
# Phase 3's shapes: (label, grid, slots or queries, input). The first of
# each kernel is the main path's shape, which the JSON line reports.
K1_CASES = (("15x15", BENCH_GRID, 1 << 17, "uniform"),
            ("15x15 crowd", BENCH_GRID, 1 << 17, "crowd"),
            ("15x15 1M", BENCH_GRID, 1 << 20, "uniform"),
            ("256x256", WIDE_GRID, 1 << 17, "uniform"),
            ("256x256 crowd", WIDE_GRID, 1 << 17, "crowd"),
            ("4x1 one bin", SOAK_GRID, 1 << 17, "one_bin"),
            ("4x1 quarter NaN", SOAK_GRID, 1 << 17, "nan"))
K2_CASES = (("15x15", BENCH_GRID, 4096), ("256x256", WIDE_GRID, 1024))
# F6: cells whose centres are not exact in float32, where the cells
# plane's fused centre (one rounding) moves pairs.
ODD_GRID = dict(offset_x=-317.5, offset_z=-123.25, cell_w=37.3, cell_h=61.1, cols=11, rows=5)
# Phase 5: scripts/sim_bench.py's world (its 100K-agent claim), uncut.
SIM_GRID = dict(offset_x=0.0, offset_z=0.0, cell_w=100.0, cell_h=100.0, cols=64, rows=64)
SIM_SWAP_GRID = dict(offset_x=0.0, offset_z=0.0, cell_w=200.0, cell_h=200.0, cols=32, rows=32)
SIM_PARAMS = dict(dt=0.05, max_speed=6.0, accel=24.0, separation=0.6, cohesion=0.15,
                  arrive_radius=1.5, crowd=32, p_wander=0.2, p_seek=0.1, p_idle=0.05)
SIM_SIZE = dict(agents=100_000, followers=1024, sensors=3072, subs=4096, ticks=30)
SIM_SEED = 20
QUERY_ROWS_MAX = 8192  # queryplane_rows_max


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def report_failure(e: PhaseFailed) -> None:
    """The failed check, on standard output and on standard error (whose
    end is what a runner that keeps only the end of the log shows)."""
    print(f"FAILED: {e}")
    print(f"chip_smoke FAILED: {e}", file=sys.stderr)


# ---- timing ---------------------------------------------------------------


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def tick_stats(xs) -> str:
    return f"median {statistics.median(xs):.3f} ms p99 {float(np.percentile(xs, 99)):.3f} ms"


def median_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps: int = 200) -> float:
    """Device time per call of ``reps`` calls run back to back: the calls
    are queued behind a sleeping kernel, so the device runs them with no
    host time between them, and CUDA events around the run divide by
    ``reps``. Retries with a longer sleep if the host had not queued them
    all before the sleep ended."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the sleep still ran: all calls were queued
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise PhaseFailed("the host could not queue the calls ahead of the device")


def device_kernels(fn, reps: int = 20) -> dict:
    """{kernel name: (device ms per call, launches per call)} of the
    device kernels ``fn`` runs, from a torch.profiler CUDA trace ({} if
    it records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if us > 0:
            out[e.key] = (us / reps / 1e3, e.count / reps)
    return out


def kernel_device_ms(fn, name_part: str, reps: int = 20):
    """Device time per call of the kernels whose name contains
    ``name_part``, from torch.profiler (None if three traces record
    none: a trace has come back without a kernel's events)."""
    for _ in range(3):
        ms = sum(t for k, (t, _) in device_kernels(fn, reps).items() if name_part in k)
        if ms:
            return ms
    return None


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---- inputs -----------------------------------------------------------------


def entity_inputs(grid, n: int, rng: np.random.Generator, device, what: str = "uniform"):
    """Positions over the grid and a margin around it, a quarter exactly
    on cell boundaries, plus NaN/±inf/1e20 rows and invalid slots. A
    ``crowd`` puts half of the slots, valid, inside one cell; ``one_bin``
    every valid slot inside one cell (12a's stampede); ``nan`` a quarter
    of the rows at NaN (12a's sim.step_nan), which K1 counts in cell 0
    (ROADMAP F1)."""
    lo_x, lo_z = grid.offset_x - grid.cell_w, grid.offset_z - grid.cell_h
    hi_x = grid.offset_x + grid.cell_w * (grid.cols + 1)
    hi_z = grid.offset_z + grid.cell_h * (grid.rows + 1)
    pos = np.stack([rng.uniform(lo_x, hi_x, n), rng.uniform(-50, 50, n),
                    rng.uniform(lo_z, hi_z, n)], axis=1).astype(np.float32)
    k = n // 4
    pos[:k, 0] = grid.offset_x + rng.integers(-1, grid.cols + 2, k) * grid.cell_w
    pos[:k, 2] = grid.offset_z + rng.integers(-1, grid.rows + 2, k) * grid.cell_h
    special = [np.nan, np.inf, -np.inf, 1e20, -1e20]
    for i, v in enumerate(special):
        pos[k + 8 * i: k + 8 * i + 4, 0] = v
        pos[k + 8 * i + 4: k + 8 * i + 8, 2] = v
    valid = rng.random(n) > 0.05
    if what == "crowd":
        idx = rng.permutation(n)[: n // 2]
        pos[idx, 0] = grid.offset_x + grid.cell_w * (7 + rng.random(idx.size))
        pos[idx, 2] = grid.offset_z + grid.cell_h * (7 + rng.random(idx.size))
        valid[idx] = True
    elif what == "one_bin":
        pos[:, 0] = grid.offset_x + grid.cell_w * (grid.cols // 2 + rng.random(n))
        pos[:, 2] = grid.offset_z + grid.cell_h * (grid.rows // 2 + rng.random(n))
    elif what == "nan":
        idx = rng.permutation(n)[: n // 4]
        pos[idx] = np.nan
    return (torch.from_numpy(pos).to(device), torch.from_numpy(valid).to(device))


def query_inputs(grid, q: int, rng: np.random.Generator, device):
    """Queries of every kind, a quarter centred on cell corners; an eighth
    of the extents are 0, -0, negative, NaN, ±inf or a multiple of half
    a cell."""
    kind = rng.integers(0, 5, q).astype(np.int32)  # NONE..SPOTS
    lo = grid.offset_x - grid.cell_w
    hi = grid.offset_x + grid.cell_w * (grid.cols + 1)
    center = rng.uniform(lo, hi, (q, 2)).astype(np.float32)
    center[: q // 4] = (grid.offset_x + rng.integers(
        -1, grid.cols + 1, (q // 4, 2)) * grid.cell_w).astype(np.float32)
    extent = rng.uniform(1.0, grid.cell_w * 4, (q, 2)).astype(np.float32)
    odd = rng.random((q, 2)) < 0.125
    extent[odd] = rng.choice(np.array(
        [0.0, -0.0, -3.0, np.nan, np.inf, -np.inf, grid.cell_w * 0.5, grid.cell_w * 1.5],
        np.float32), odd.sum())
    direction = rng.normal(size=(q, 2)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    angle = rng.uniform(0.05, 1.5, q).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (kind, center, extent, direction, angle)]


def k1_cases(ops, dev):
    """(label, grid, positions, valid) of each K1 case, seeded per case."""
    for i, (label, gkw, n, what) in enumerate(K1_CASES):
        grid = ops.GridSpec(**gkw)
        rng = np.random.default_rng(SEED + 100 + i)
        yield (label, grid, *entity_inputs(grid, n, rng, dev, what))


def k2_cases(ops, dev):
    """(label, grid, (kind, center, extent, direction, cos_angle)) of each
    K2 case, seeded per case."""
    for i, (label, gkw, q) in enumerate(K2_CASES):
        grid = ops.GridSpec(**gkw)
        rng = np.random.default_rng(SEED + 200 + i)
        kind, center, extent, direction, angle = query_inputs(grid, q, rng, dev)
        yield label, grid, (kind, center, extent, direction, torch.cos(angle))


# ---- phases -----------------------------------------------------------------


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"count {torch.cuda.device_count()}")
    print(card)
    return name, card


def phase_build(K) -> None:
    t0 = time.perf_counter()
    logs = K.build()
    secs = time.perf_counter() - t0
    report = []
    for name, log in logs.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        report.append(f"{name}: {' | '.join(used)}")
    print(f"build: {len(K.KERNEL_SPECS)} kernels in {secs:.2f} s; " + "; ".join(report))


def max_abs_diff(pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())
               if a.numel() else 0 for a, b in pairs)


def phase_kernels(K, ops, dev) -> dict:
    """Each kernel against its plain version on the card, exact, at every
    case; times each (call, bare launches back to back by CUDA events,
    torch.profiler, plain) beside its bound. Returns the JSON entries at
    the main path's shapes, without launches."""
    entries, alone = {}, {}
    for label, grid, pos, valid in k1_cases(ops, dev):
        n, c = pos.shape[0], grid.num_cells
        shared = K.uses_shared_histogram(grid, dev)
        cell_k, counts_k = K.assign_and_count(grid, pos, valid)
        cell_p, counts_p = K.assign_and_count_plain(grid, pos, valid)
        torch.cuda.synchronize()
        err = max_abs_diff([(cell_k, cell_p), (counts_k, counts_p)])
        check(err == 0, f"K1 {label}: kernel differs from plain (max |diff| {err})")
        check(int(counts_k.sum()) == int((cell_k >= 0).sum()), f"K1 {label}: counts do not add up")
        check(shared == (grid.cols != 256), f"K1 {label}: wrong histogram path")
        launch = K.prepare_assign_count(grid, pos, valid)
        alone[label] = queued_ms(launch.run)
        ms = median_ms(lambda: K.assign_and_count(grid, pos, valid))
        plain = median_ms(lambda: K.assign_and_count_plain(grid, pos, valid))
        kernels = device_kernels(lambda: K.assign_and_count(grid, pos, valid))
        prof_ms = sum(t for k, (t, _) in kernels.items() if "assign_count" in k) or None
        if kernels:  # one launch per call, and no zero-fill before it
            others = [k for k in kernels if "assign_count" not in k]
            check(not others, f"K1 {label}: a call ran {kernels}")
        b, by = bound_ms(pos.numel() * 4 + valid.numel() + 4 * n + 4 * c,
                         ASSIGN_OPS_PER_SLOT * n)
        print(f"K1 assign_count {label} N={n} C={c} "
              f"{'shared-memory' if shared else 'global-atomic'} histogram: exact "
              f"({int((cell_k >= 0).sum())} placed; kernels of a call: "
              f"{sorted(k.split('::')[-1][:28] for k in kernels) or 'not measured'}); "
              f"alone {alone[label]:.4f} ms (events, bare launches; "
              f"profiler {fmt_ms(prof_ms)}), call {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {b:.5f} ms ({by})")
        if "assign_count" not in entries:
            entries["assign_count"] = dict(max_abs_err=err, ms=alone[label], call_ms=ms,
                                           plain_ms=plain, bound_ms=b, bound_by=by)
    print(f"K1 crowd / uniform at N=131072 (alone, events): 15x15 "
          f"{alone['15x15 crowd'] / alone['15x15']:.3f}, 256x256 "
          f"{alone['256x256 crowd'] / alone['256x256']:.3f}")
    for label, grid, args in k2_cases(ops, dev):
        q, c = args[0].shape[0], grid.num_cells
        hit_k, dist_k = K.aoi_tile(grid, *args)
        hit_p, dist_p = K.aoi_tile_plain(grid, *args)
        torch.cuda.synchronize()
        err = max_abs_diff([(hit_k, hit_p), (dist_k, dist_p)])
        check(err == 0, f"K2 {label}: kernel differs from plain (max |diff| {err})")
        # Blocks of cell columns, as the cell-sharded plane would ask; the
        # last one runs past the grid into padding ids.
        for base, count in ((c // 3, c // 3), (c - 100, 164)):
            hb, db = K.aoi_tile(grid, *args, base, count)
            hp, dp = K.aoi_tile_plain(grid, *args, base, count)
            torch.cuda.synchronize()
            check(torch.equal(hb, hp) and torch.equal(db, dp),
                  f"K2 {label}: cell block [{base}, +{count}) differs")
        launch = K.prepare_aoi(grid, *args, 0, c)
        alone[label] = queued_ms(launch.run, reps=200 if q * c < 1 << 24 else 40)
        ms = median_ms(lambda: K.aoi_tile(grid, *args))
        plain = median_ms(lambda: K.aoi_tile_plain(grid, *args), reps=20, warmup=2)
        prof_ms = kernel_device_ms(lambda: K.aoi_tile(grid, *args), "aoi_kernel")
        b, by = bound_ms(q * (4 + 3 * 8 + 4) + q * c * 5,
                         AOI_OPS_PER_PAIR * q * c
                         + AOI_OPS_PER_AXIS * q * (grid.cols + grid.rows))
        print(f"K2 aoi {label} Q={q} C={c}: exact ({int(hit_k.sum())} hits, cell blocks "
              f"exact); alone {alone[label]:.4f} ms (events, bare launches; profiler "
              f"{fmt_ms(prof_ms)}), call {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{b:.5f} ms ({by})")
        if "aoi" not in entries:
            entries["aoi"] = dict(max_abs_err=err, ms=alone[label], call_ms=ms,
                                  plain_ms=plain, bound_ms=b, bound_by=by)
        else:  # the write floor of this shape's outputs, a yardstick only
            floor = queued_ms(lambda: (hit_k.fill_(0), dist_k.fill_(0)), reps=40)
            print(f"K2 write floor {label}: hit.fill_(0) + dist.fill_(0) on "
                  f"[{q},{c}] {floor:.4f} ms (events); kernel alone / floor "
                  f"{alone[label] / floor:.3f}")
    entries["aoi"]["fused_block"] = phase_fused_block(K, ops, dev)
    return entries


def phase_fused_block(K, ops, dev) -> dict:
    """K2 with ``fused_centre`` (the cells serving plane's: each cell
    centre rounded once, ROADMAP F6) against its plain twin, exact, on
    11x5 cells of 37.3 x 61.1 m in the plane's blocks over 8 shards and
    whole; then one shard's block of the sidecar's grid (4,096 x 29 from
    cell 203) timed fused and unfused, bare launches by events."""
    grid = ops.GridSpec(**ODD_GRID)
    rng = np.random.default_rng(SEED + 300)
    kind, center, extent, direction, angle = query_inputs(grid, 4096, rng, dev)
    args = (kind, center, extent, direction, torch.cos(angle))
    moved = 0
    for base, count in [(s * 7, 7) for s in range(8)] + [(0, grid.num_cells)]:
        got = K.aoi_tile(grid, *args, base, count, fused_centre=True)
        want = K.aoi_tile_plain(grid, *args, base, count, fused_centre=True)
        unfused = K.aoi_tile(grid, *args, base, count)
        torch.cuda.synchronize()
        err = max_abs_diff(zip(got, want))
        check(err == 0, f"K2 fused block [{base}, +{count}): kernel differs from plain "
                        f"(max |diff| {err})")
        if count == grid.num_cells:
            moved = sum(int((a != b).sum()) for a, b in zip(got, unfused))
    grid = ops.GridSpec(**BENCH_GRID)
    kind, center, extent, direction, angle = query_inputs(grid, 4096, rng, dev)
    args = (kind, center, extent, direction, torch.cos(angle))
    base, blk = 203, 29
    got = K.aoi_tile(grid, *args, base, blk, fused_centre=True)
    want = K.aoi_tile_plain(grid, *args, base, blk, fused_centre=True)
    torch.cuda.synchronize()
    err = max_abs_diff(zip(got, want))
    check(err == 0, f"K2 fused block 4096 x {blk}: kernel differs from plain (max |diff| {err})")
    fused_ms = queued_ms(K.prepare_aoi(grid, *args, base, blk, fused_centre=True).run)
    unfused_ms = queued_ms(K.prepare_aoi(grid, *args, base, blk).run)
    plain = median_ms(lambda: K.aoi_tile_plain(grid, *args, base, blk, fused_centre=True),
                      reps=20, warmup=2)
    q = kind.shape[0]
    axes = min(grid.cols, blk) + len({i // grid.cols for i in range(base, base + blk)})
    b, by = bound_ms(q * (4 + 3 * 8 + 4) + q * blk * 5,
                     AOI_OPS_PER_PAIR * q * blk + AOI_OPS_PER_AXIS * q * axes)
    print(f"K2 fused centre (cells plane, F6): exact against plain on {ODD_GRID['cols']}x"
          f"{ODD_GRID['rows']} cells of {ODD_GRID['cell_w']} x {ODD_GRID['cell_h']} m in 8 "
          f"blocks of 7 and whole ({moved} hit/dist values of 4096 x 55 differ from the "
          f"unfused kernel); 4096 x {blk} from cell {base} on 15x15: alone fused "
          f"{fused_ms:.4f} ms, unfused {unfused_ms:.4f} ms (events, bare launches), plain "
          f"{plain:.4f} ms, bound {b:.5f} ms ({by})")
    return dict(shape=f"4096 x {blk} from cell {base}", max_abs_err=err, ms=fused_ms,
                unfused_ms=unfused_ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=None)


# ---- the main path ------------------------------------------------------


class Load:
    """Seeded sidecar traffic: 100K moving entities, 4,096 standing
    queries of every kind, ~16K subscriptions, churn on all three."""

    WORLD = 30000.0

    def __init__(self, rng: np.random.Generator, n_entities=100_000,
                 n_queries=4096, n_subs=16384):
        self.rng = rng
        self.ids = np.arange(1, n_entities + 1, dtype=np.int64) + 0x80000
        lo = BENCH_GRID["offset_x"]
        self.pos = rng.uniform(lo, lo + self.WORLD, (n_entities, 3)).astype(np.float32)
        self.pos[:, 1] = 0.0
        speed = rng.uniform(0, 60, n_entities)
        heading = rng.uniform(0, 2 * np.pi, n_entities)
        self.vel = np.stack([speed * np.cos(heading), np.zeros(n_entities),
                             speed * np.sin(heading)], axis=1).astype(np.float32)
        # Pinned hazards: NaN, ±inf, 1e20 and exact cell boundaries.
        self.pos[:6, 0] = [np.nan, np.inf, -np.inf, 1e20, -15000.0, 1000.0]
        self.pos[:6, 2] = [0.0, 0.0, 0.0, 0.0, -13000.0, np.nan]
        self.vel[:6] = 0.0
        self.next_id = int(self.ids[-1]) + 1
        self.conns = list(range(1, n_queries + 1))
        self.next_conn = n_queries + 1
        self.removed_conns: list[int] = []
        self.subs = list(range(1, n_subs + 1))
        self.next_sub = n_subs + 1

    def query(self, conn: int):
        r = self.rng
        kind = int(r.choice([0, 1, 1, 1, 2, 2, 3, 3, 4]))
        lo = BENCH_GRID["offset_x"]
        c = r.uniform(lo - 2000, lo + self.WORLD + 2000, 2).astype(np.float32)
        if r.random() < 0.25:  # centre on a cell corner
            c = (lo + r.integers(0, 16, 2) * 2000.0).astype(np.float32)
        d = r.normal(size=2)
        q = NS(connId=conn, kind=kind, centerX=float(c[0]), centerZ=float(c[1]),
               extentX=float(np.float32(r.uniform(100, 8000))),
               extentZ=float(np.float32(r.uniform(100, 8000))),
               dirX=float(np.float32(d[0])), dirZ=float(np.float32(d[1])),
               angle=float(np.float32(r.uniform(0.05, 1.5))),
               spotX=[], spotZ=[], spotDists=[])
        if kind == 4:
            k = int(r.integers(1, 8))
            q.spotX = [float(v) for v in r.uniform(lo - 1000, lo + self.WORLD, k).astype(np.float32)]
            q.spotZ = [float(v) for v in r.uniform(lo - 1000, lo + self.WORLD, k).astype(np.float32)]
            q.spotDists = [int(v) for v in r.integers(0, 6, int(r.integers(0, k + 1)))]
        return q

    def sub(self, sub_id: int, now_ms: int):
        return NS(subId=sub_id, fanOutIntervalMs=int(self.rng.integers(33, 201)),
                  firstDueMs=int(now_ms + self.rng.integers(0, 200)))

    def request(self, step: int):
        r = self.rng
        now = 1000 + 33 * step
        lo = BENCH_GRID["offset_x"]
        moved = self.pos + self.vel
        with np.errstate(invalid="ignore"):  # the pinned NaN/inf rows
            moved[:, 0] = (moved[:, 0] - lo) % self.WORLD + lo
            moved[:, 2] = (moved[:, 2] - lo) % self.WORLD + lo
        moved[:6] = self.pos[:6]
        if step == 10:  # a burst that overflows the 4,096 handover rows
            burst = r.choice(np.arange(6, len(self.pos)), 9000, replace=False)
            moved[burst, 0] = (moved[burst, 0] - lo + 2000.0) % self.WORLD + lo
        self.pos = moved.astype(np.float32)
        updates = [NS(entityId=int(e), x=float(x), y=float(y), z=float(z))
                   for e, (x, y, z) in zip(self.ids, self.pos.tolist())]
        removed_entities = []
        if step > 0:  # churn: 50 entities leave, 50 join (slot reuse)
            gone = r.choice(np.arange(6, len(self.ids)), 50, replace=False)
            removed_entities = [int(e) for e in self.ids[gone]]
            fresh = np.arange(self.next_id, self.next_id + 50)
            self.next_id += 50
            self.ids[gone] = fresh
        queries, removed_conns = [], []
        if step == 0:
            queries = [self.query(c) for c in self.conns]
        else:
            for c in r.choice(self.conns, 64, replace=False):
                queries.append(self.query(int(c)))
            # Rows freed last step are taken by new connections now.
            for _ in self.removed_conns:
                self.conns.append(self.next_conn)
                queries.append(self.query(self.next_conn))
                self.next_conn += 1
            touched = {q.connId for q in queries}
            keep = [c for c in self.conns if c not in touched]
            removed_conns = [int(c) for c in r.choice(keep, 8, replace=False)]
            self.conns = [c for c in self.conns if c not in removed_conns]
        self.removed_conns = removed_conns
        if step == 0:
            add_subs = [self.sub(s, now) for s in self.subs]
            remove_subs = []
        else:
            remove_subs = [int(s) for s in r.choice(self.subs, 100, replace=False)]
            gone = set(remove_subs)
            self.subs = [s for s in self.subs if s not in gone]
            add_subs = [self.sub(s, now) for s in range(self.next_sub, self.next_sub + 100)]
            self.subs += list(range(self.next_sub, self.next_sub + 100))
            self.next_sub += 100
        return NS(nowMs=now, updates=updates, removedEntityIds=removed_entities,
                  queries=queries, removedQueryConnIds=removed_conns,
                  addSubscriptions=add_subs, removeSubIds=remove_subs,
                  fullInterest=(step == 0))


def config_request():
    return NS(worldOffsetX=BENCH_GRID["offset_x"], worldOffsetZ=BENCH_GRID["offset_z"],
              gridWidth=BENCH_GRID["cell_w"], gridHeight=BENCH_GRID["cell_h"],
              gridCols=BENCH_GRID["cols"], gridRows=BENCH_GRID["rows"],
              entityCapacity=0, queryCapacity=0, subCapacity=0, meshDevices=0, meshHosts=0)


def same_decision(a, b) -> list[str]:
    diffs = []
    if a.handover_count != b.handover_count:
        diffs.append(f"handover_count {a.handover_count} != {b.handover_count}")
    if a.handovers != b.handovers:
        diffs.append("handover rows differ")
    if not np.array_equal(a.cell_counts, b.cell_counts):
        diffs.append("cell counts differ")
    if [i[0] for i in a.interests] != [i[0] for i in b.interests] or any(
        not (np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2]))
        for x, y in zip(a.interests, b.interests)
    ):
        diffs.append("interest rows differ")
    if a.due_sub_ids != b.due_sub_ids:
        diffs.append("due ids differ")
    return diffs


def phase_main_path(K, service, dev, steps: int = 30) -> dict:
    """The sidecar's decision pass on the card against the CPU port."""
    gpu = service.SpatialDecisionServicer(device=dev)
    cpu = service.SpatialDecisionServicer(device="cpu")
    gpu.install(config_request())
    cpu.install(config_request())
    eng = gpu.engine
    check(eng.device.type == "cuda", "the GPU servicer's engine is not on cuda")
    tick_ms = []
    orig_tick = eng.tick

    def timed_tick(now_ms=None):
        t0 = time.perf_counter()
        result = orig_tick(now_ms)
        eng.consume(result)  # the tick's readback, which waits for the device
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        return result

    eng.tick = timed_tick
    load = Load(np.random.default_rng(SEED + 1))
    step_ms, stats = [], dict(handovers=0, overflow_steps=0, interest_rows=0, due=0)
    K.reset_launch_counts()
    decisions = []
    for step in range(steps):
        req = load.request(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_gpu = gpu.decide(req)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        decisions.append(d_gpu)
    counts = K.launch_counts()
    profile_window(gpu, load, steps)
    # The CPU reference run is outside the counted window.
    load = Load(np.random.default_rng(SEED + 1))
    for step in range(steps):
        d_cpu = cpu.decide(load.request(step))
        d_gpu = decisions[step]
        diffs = same_decision(d_gpu, d_cpu)
        check(not diffs, f"step {step}: cuda and cpu decisions differ: {diffs}")
        stats["handovers"] += len(d_gpu.handovers)
        stats["overflow_steps"] += d_gpu.handover_count > 4096
        stats["interest_rows"] += len(d_gpu.interests)
        stats["due"] += len(d_gpu.due_sub_ids)
        check(int(d_gpu.cell_counts.sum()) > 90_000, f"step {step}: entities went missing")
    check(stats["overflow_steps"] >= 1, "no step overflowed the handover rows")
    for name, n in counts.items():
        check(n == steps, f"kernel {name} launched {n} times in {steps} steps")
    p99 = float(np.percentile(step_ms, 99))
    print(f"main path: {steps} sidecar steps on cuda equal the CPU port step for step "
          f"(N=100000 moving, Q=4096, S~16K, {stats['handovers']} handovers, "
          f"{stats['overflow_steps']} overflow steps, {stats['interest_rows']} interest "
          f"rows, {stats['due']} due); launches {counts}; step median "
          f"{statistics.median(step_ms):.2f} ms p99 {p99:.2f} ms; tick+readback median "
          f"{statistics.median(tick_ms):.2f} ms p99 {float(np.percentile(tick_ms, 99)):.2f} ms")
    return counts


def device_rows(prof, n: int) -> list:
    """[(name, device ms per tick, launches per tick)] of the device-side
    events of a torch.profiler trace over n ticks: kernels, copies and
    fills. The CPU-side operator events are left out: some carry the
    device time of the kernels they launch as their own, which would
    count that time twice."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def profile_window(servicer, load, first_step: int, n: int = 5) -> None:
    """Where a step's time goes: n more steps under torch.profiler,
    after the counted run. Prints device time per step (kernels and
    copies), the device's idle share of the step, K1's kernels and the
    fills of a tensor of the grid's bin count (what zeroing K1's counts
    would be) per step, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [load.request(first_step + i) for i in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for req in reqs:
            servicer.decide(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [(k, ms, int(c)) for k, ms, c in device_rows(prof, n)]
    device_ms = sum(r[1] for r in rows)
    if not rows:
        print("profile: the trace recorded no device time (not measured)")
        return
    top = sorted(rows, key=lambda r: -r[1])[:6]
    k1 = sum(c for k, _, c in rows if "assign_count" in k)
    bins = int(servicer.engine.grid.cols) * int(servicer.engine.grid.rows)
    fills = {str(e.input_shapes[:1]): e.count // n
             for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::fill_"}
    bin_fills = sum(c for shape, c in fills.items() if shape == str([[bins]]))
    print(f"profile ({n} steps): step wall {wall_ms:.2f} ms, device busy {device_ms:.3f} ms "
          f"per step, idle share {1 - device_ms / wall_ms:.4f}; K1 kernels per step {k1}; "
          f"fills of a [{bins}] tensor per step {bin_fills} (all fills by shape {fills}); "
          f"top: " + "; ".join(
              f"{k[:48]} {ms:.3f} ms x{c}" for k, ms, c in top))


# ---- the sim world ------------------------------------------------------


class Reads:
    """Counts reads of CUDA tensors into host memory while entered: the
    ways a tensor's data reaches the host in the port (``cpu``,
    ``numpy``, ``item``, ``tolist`` and the bool/int/float/index
    conversions), as scripts/sim_bench.py counts ``np.asarray`` on
    device arrays. Also counts every point where the host waited for the
    card (``syncs``, from PyTorch's sync debug mode, which also sees
    waits inside library ops and host-to-device copies)."""

    NAMES = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self):
        self.count = 0
        self.syncs = 0

    def __enter__(self):
        self._saved = {n: torch.Tensor.__dict__.get(n) for n in self.NAMES}
        for name in self.NAMES:
            fn = getattr(torch.Tensor, name)

            def counted(t, *args, _fn=fn, **kwargs):
                if t.is_cuda:
                    self.count += 1
                return _fn(t, *args, **kwargs)

            setattr(torch.Tensor, name, counted)
        self._caught = warnings.catch_warnings(record=True)
        self._log = self._caught.__enter__()
        warnings.simplefilter("always")
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        self.syncs = sum("synchroniz" in str(w.message) for w in self._log)
        self._caught.__exit__(*exc)
        for name, fn in self._saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        return False


def sim_columns(eng) -> list:
    return [t.cpu().numpy() for t in
            (eng._d_positions, eng._d_vel, eng._d_sim_state, eng._d_sim_target)]


def digest(arrays) -> list[str]:
    return [hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() for a in arrays]


def cell_seeds(eng, grid) -> dict:
    """{slot: cell} rebuild baselines from the host-shadow positions
    (truncated and clamped into the grid, as tests/test_sim.py seeds)."""
    slots = np.fromiter(eng._slot_of_entity.values(), np.int64, len(eng._slot_of_entity))
    x, z = eng._positions[slots, 0], eng._positions[slots, 2]
    col = np.clip(((x - grid.offset_x) / grid.cell_w).astype(np.int64), 0, grid.cols - 1)
    row = np.clip(((z - grid.offset_z) / grid.cell_h).astype(np.int64), 0, grid.rows - 1)
    return dict(zip(slots.tolist(), (row * grid.cols + col).tolist()))


class SimWorld:
    """Phase 5's seeded world on one device: scripts/sim_bench.py's
    100K-agent engine with the standing-query plane armed, and its
    per-tick drive."""

    def __init__(self, engine_mod, ops, dev, run_sim: bool):
        self.ops, self.dev = ops, dev
        grid = ops.GridSpec(**SIM_GRID)
        eng = engine_mod.SpatialEngine(grid, entity_capacity=1 << 17, query_capacity=4096,
                                       max_handovers=4096, query_rows_max=QUERY_ROWS_MAX,
                                       device=dev)
        n, world = SIM_SIZE["agents"], SIM_GRID["cols"] * SIM_GRID["cell_w"]
        rng = np.random.default_rng(SIM_SEED)
        xs = rng.uniform(1.0, world - 1.0, n)
        zs = rng.uniform(1.0, world - 1.0, n)
        eng.seed_agents([(0x480000 + i, float(xs[i]), 0.0, float(zs[i])) for i in range(n)],
                        SIM_SEED, ops.SimParams(**SIM_PARAMS))
        eng.run_sim_pass = run_sim
        eng.track_query_changes = True
        self.eng = eng
        q = np.random.default_rng(SIM_SEED + 1)
        self.followed = eng.agent_slots()[q.choice(n, SIM_SIZE["followers"], replace=False)]
        self.follow()
        for i in range(SIM_SIZE["sensors"]):  # scripts/query_bench.py's mix, at this cell size
            conn = 10_000 + i
            x, z = (float(v) for v in q.uniform(0.0, world, 2))
            if i % 64 == 63:
                eng.set_spots_query(conn, [(x, z)], [1])
            else:
                eng.set_query(conn, (ops.AOI_BOX, ops.AOI_CONE)[i % 2], (x, z),
                              (float(q.uniform(75, 250)), float(q.uniform(75, 250))),
                              (1.0, 0.0), 0.7)
        for _ in range(SIM_SIZE["subs"]):
            eng.add_subscription(int(q.integers(50, 201)), int(q.integers(0, 200)))
        self.flee = [q.choice(grid.num_cells, 64, replace=False).tolist() for _ in range(2)]
        eng.set_flee_cells(self.flee[0])
        self.tick_ms: list[float] = []
        self.reads: list[int] = []
        self.syncs: list[int] = []
        self.census_ms = 0.0

    def follow(self) -> None:
        """Re-centre each follower sphere on its agent's host-shadow
        position, which the census refreshes: no device read."""
        pos = self.eng._positions
        for i, slot in enumerate(self.followed):
            self.eng.set_query(1 + i, self.ops.AOI_SPHERE,
                               (float(pos[slot, 0]), float(pos[slot, 2])), (150.0, 0.0))

    def tick(self, t: int) -> dict:
        """One tick as the gateway drives it: the flee mask changes at
        the half, followers re-centre, the census is due on the last
        tick. Host clock and device reads are counted over the tick and
        its readbacks (the census fetch included)."""
        eng = self.eng
        if t == SIM_SIZE["ticks"] // 2:
            eng.set_flee_cells(self.flee[1])
        self.follow()
        eng.sim_census_due = t == SIM_SIZE["ticks"] - 1
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        with Reads() as reads:
            t0 = time.perf_counter()
            out = eng.tick(now_ms=1000 + 33 * t)
            count, _, counts, due = eng.consume(out)
            q_count, q_rows = eng.query_changed_rows(out)
            handovers = eng.handover_list(out)
            t1 = time.perf_counter()
            census = None
            if "sim_census" in out:
                census = tuple(c.cpu().numpy() for c in out["sim_census"])
                eng.absorb_census(eng.agent_slots(), *census)
            t2 = time.perf_counter()
        eng.sim_census_due = False
        self.tick_ms.append((t1 - t0) * 1e3)
        self.census_ms += (t2 - t1) * 1e3
        self.reads.append(reads.count)
        self.syncs.append(reads.syncs)
        return dict(count=count, handovers=handovers, counts=counts.copy(),
                    due=np.nonzero(due)[0].tolist(), q_count=q_count,
                    q_rows=q_rows[: min(q_count, len(q_rows))].copy(), census=census is not None)

    def recover(self) -> tuple[dict, dict]:
        """Rebuild + verify; corrupt + rebuild + verify; a swap to the
        32x32 grid + verify; one tick on it. Returns (times in ms, the
        tick's observation)."""
        eng, ops = self.eng, self.ops
        ms = {}
        t0 = time.perf_counter()
        seeds = cell_seeds(eng, eng.grid)
        eng.rebuild_device_state(seeds, now_ms=3000)
        t1 = time.perf_counter()
        errors = eng.verify_device_state(seeds)
        t2 = time.perf_counter()
        check(errors == [], f"verify after rebuild on {self.dev}: {errors}")
        ms["rebuild"], ms["verify"] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        eng.corrupt_device_state_for_chaos()
        check(eng.verify_device_state(seeds) != [], f"corruption not found on {self.dev}")
        eng.rebuild_device_state(seeds, now_ms=3001)
        errors = eng.verify_device_state(seeds)
        check(errors == [], f"verify after corrupt + rebuild on {self.dev}: {errors}")
        grid = ops.GridSpec(**SIM_SWAP_GRID)
        seeds = cell_seeds(eng, grid)
        t0 = time.perf_counter()
        eng.apply_grid(grid, seeds, now_ms=3002)
        errors = eng.verify_device_state(seeds)
        ms["apply_grid_verify"] = (time.perf_counter() - t0) * 1e3
        check(errors == [], f"verify after apply_grid on {self.dev}: {errors}")
        check(eng.query_epoch == 3, f"query epoch {eng.query_epoch} after three rebuilds")
        return ms, self.tick(SIM_SIZE["ticks"])


def same_sim_tick(a: dict, b: dict) -> list[str]:
    diffs = [k for k in ("count", "handovers", "due", "q_count", "census") if a[k] != b[k]]
    return diffs + [k for k in ("counts", "q_rows") if not np.array_equal(a[k], b[k])]


def first_column_diff(a: list, b: list) -> Optional[str]:
    """The first sim column whose bits differ, with its largest
    difference (None when all four are bit-identical)."""
    for name, x, y in zip(("positions", "vel", "state", "target"), a, b):
        if not np.array_equal(x.view(np.int32), y.view(np.int32)):
            bad = np.nonzero((x.view(np.int32) != y.view(np.int32)).reshape(len(x), -1))[0]
            return (f"{name}: {len(bad)} slots differ, first {bad[:4].tolist()}, max |diff| "
                    f"{np.nanmax(np.abs(x.astype(np.float64) - y.astype(np.float64)))}")
    return None


def profile_ticks(world: SimWorld, first: int, n: int = 5) -> dict:
    """n more sim ticks under torch.profiler: device busy and idle share
    of a tick, and launches per tick of each kernel (None: the trace
    recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            world.tick(first + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = device_rows(prof, n)
    if not rows:
        return dict(wall_ms=wall, busy_ms=None, idle=None, k1=None, k2=None, top=[])
    busy = sum(r[1] for r in rows)
    return dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
                k1=sum(c for k, _, c in rows if "assign_count" in k),
                k2=sum(c for k, _, c in rows if "aoi_kernel" in k),
                top=sorted(rows, key=lambda r: -r[1])[:6])


def sim_path_kernels(K, eng) -> dict:
    """K1 and K2 against their plain versions on the sim world's live
    tensors (131,072 slots x 4,096 bins; 4,096 x 4,096 pairs), exact,
    with times and bounds. Returns the JSON's ``sim_path`` entries."""
    grid, dev = eng.grid, eng.device
    pos, valid = eng._d_positions, eng._d_valid
    n, c = pos.shape[0], grid.num_cells
    got, want = K.assign_and_count(grid, pos, valid), K.assign_and_count_plain(grid, pos, valid)
    err1 = max_abs_diff(zip(got, want))
    check(err1 == 0, f"K1 at the sim path's shape differs from plain (max |diff| {err1})")
    qs = eng._d_queries
    args = (qs.kind, qs.center, qs.extent, qs.direction, torch.cos(qs.angle))
    q = args[0].shape[0]
    got, want = K.aoi_tile(grid, *args), K.aoi_tile_plain(grid, *args)
    err2 = max_abs_diff(zip(got, want))
    check(err2 == 0, f"K2 at the sim path's shape differs from plain (max |diff| {err2})")
    b1, by1 = bound_ms(pos.numel() * 4 + n + 4 * n + 4 * c, ASSIGN_OPS_PER_SLOT * n)
    b2, by2 = bound_ms(q * (4 + 3 * 8 + 4) + q * c * 5,
                       AOI_OPS_PER_PAIR * q * c + AOI_OPS_PER_AXIS * q * (grid.cols + grid.rows))
    out = {
        "assign_count": dict(
            shape=f"{n} slots x {c} bins", max_abs_err=err1, bound_ms=b1, bound_by=by1,
            ms=queued_ms(K.prepare_assign_count(grid, pos, valid).run),
            plain_ms=median_ms(lambda: K.assign_and_count_plain(grid, pos, valid))),
        "aoi": dict(
            shape=f"{q} x {c} pairs", max_abs_err=err2, bound_ms=b2, bound_by=by2,
            ms=queued_ms(K.prepare_aoi(grid, *args, 0, c).run, reps=40),
            plain_ms=median_ms(lambda: K.aoi_tile_plain(grid, *args), reps=10, warmup=2)),
    }
    for name, e in out.items():
        print(f"{name} at the sim path's shape ({e['shape']}): exact; alone {e['ms']:.4f} ms "
              f"(events, bare launches), plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']})")
    return out


def phase_sim_world(K, engine_mod, ops, dev) -> tuple[dict, dict]:
    """The sim world on the card against the CPU port, twice on the card,
    and once without the sim pass. Returns (K1/K2 launches on this path,
    the kernels' figures at this path's shapes)."""
    ticks = SIM_SIZE["ticks"]
    steady = range(1, ticks - 1)  # tick 0 full-emits; the last is the census tick
    t0 = time.perf_counter()
    base = SimWorld(engine_mod, ops, dev, run_sim=False)
    for t in range(ticks):
        base.tick(t)
    base_ms, base_reads = [base.tick_ms[t] for t in steady], [base.reads[t] for t in steady]
    base_syncs = [base.syncs[t] for t in steady]
    base_census = (base.reads[ticks - 1], base.syncs[ticks - 1])
    del base

    # Run 1: counted and timed.
    run1 = SimWorld(engine_mod, ops, dev, run_sim=True)
    run1.eng.sim_warmup()
    K.reset_launch_counts()
    obs1, digests1 = [], []
    for t in range(ticks):
        obs1.append(run1.tick(t))
        digests1.append(digest(sim_columns(run1.eng)))  # outside the counted window
    launches = K.launch_counts()
    for name, count in launches.items():
        check(count == ticks, f"kernel {name} launched {count} times in {ticks} sim ticks")
    sim_ms, sim_reads = [run1.tick_ms[t] for t in steady], [run1.reads[t] for t in steady]
    sim_syncs = [run1.syncs[t] for t in steady]
    check(obs1[0]["q_count"] > QUERY_ROWS_MAX, f"tick 0 emitted {obs1[0]['q_count']} rows, "
          f"not past the {QUERY_ROWS_MAX}-row budget")
    drained = next((t for t, o in enumerate(obs1) if o["q_count"] <= QUERY_ROWS_MAX), None)
    check(drained is not None, "the changed-rows backlog never drained")
    check(sim_reads == base_reads, f"steady-tick device reads with the sim pass {sim_reads} "
          f"!= without {base_reads}")
    check(sim_syncs == base_syncs, f"steady-tick host waits with the sim pass {sim_syncs} "
          f"!= without {base_syncs}")
    census_extra = run1.reads[ticks - 1] - base_census[0]
    census_syncs = run1.syncs[ticks - 1] - base_census[1]
    check(census_extra == 4, f"the census tick read {census_extra} more, not the 4 columns")
    eng = run1.eng
    prev_i, prev_d = eng._d_q_prev
    res = eng.last_result
    # Few reps: each call launches tens (the diff) to ~150 (the sim step)
    # kernels, and the driver's queue of pending launches must hold them.
    diff_ms = queued_ms(lambda: ops.diff_query_masks(prev_i, prev_d, res["interest"],
                                                     res["dist"], QUERY_ROWS_MAX), reps=8)
    flee = eng._d_flee
    step_ms = queued_ms(lambda: ops.sim_step(
        eng.grid, eng._d_positions, eng._d_vel, eng._d_sim_state, eng._d_sim_target,
        eng._d_agent, flee, eng.sim_params, eng.sim_seed, eng.sim_tick), reps=3)
    kernels = sim_path_kernels(K, eng)
    census_ms = run1.census_ms
    recover_ms, after1 = run1.recover()
    prof = profile_ticks(run1, ticks + 1)
    del run1

    # Run 2 on the card, in lockstep with the port on the CPU.
    run2 = SimWorld(engine_mod, ops, dev, run_sim=True)
    cpu = SimWorld(engine_mod, ops, torch.device("cpu"), run_sim=True)
    states = {}
    for t in range(ticks):
        a, b = run2.tick(t), cpu.tick(t)
        check(not same_sim_tick(a, obs1[t]), f"tick {t}: the two card runs differ: "
              f"{same_sim_tick(a, obs1[t])}")
        diffs = same_sim_tick(a, b)
        check(not diffs, f"tick {t}: cuda and cpu differ: {diffs}")
        cols_gpu, cols_cpu = sim_columns(run2.eng), sim_columns(cpu.eng)
        check(digest(cols_gpu) == digests1[t], f"tick {t}: the two card runs' sim columns differ")
        where = first_column_diff(cols_gpu, cols_cpu)
        check(where is None, f"tick {t}: cuda and cpu sim columns differ: {where}")
        for s in cols_gpu[2][run2.eng.agent_slots()].tolist():
            states[s] = states.get(s, 0) + 1
    _, after2 = run2.recover()
    _, after_cpu = cpu.recover()
    check(not same_sim_tick(after2, after1), "the two card runs differ after apply_grid")
    check(not same_sim_tick(after2, after_cpu), "cuda and cpu differ after apply_grid")
    where = first_column_diff(sim_columns(run2.eng), sim_columns(cpu.eng))
    check(where is None, f"after apply_grid, cuda and cpu sim columns differ: {where}")
    secs = time.perf_counter() - t0
    del run2, cpu

    def stats(xs):
        return statistics.median(xs), float(np.percentile(xs, 99))

    (sm, sp), (bm, bp) = stats(sim_ms), stats(base_ms)
    handovers = sum(len(o["handovers"]) for o in obs1)
    print(f"sim world: {ticks} ticks of {SIM_SIZE['agents']} agents on cuda equal the CPU port "
          f"tick for tick, sim columns bit for bit, and a second card run bit for bit "
          f"({handovers} handovers, FSM states over the run {states}, changed query rows "
          f"per tick {[o['q_count'] for o in obs1]}, backlog drained by tick {drained}); "
          f"recovery verified clean on both ({secs:.1f} s for the phase)")
    print(f"sim pass: tick+readback with sim median {sm:.3f} ms p99 {sp:.3f} ms, without "
          f"{bm:.3f} / {bp:.3f} ms, difference {sm - bm:.3f} / {sp - bp:.3f} ms (host clock, "
          f"ticks 1-{ticks - 2}); sim_step alone {step_ms:.4f} ms, diff_query_masks alone "
          f"{diff_ms:.4f} ms (events, queued)")
    print(f"device reads per steady tick: with sim {sorted(set(sim_reads))}, without "
          f"{sorted(set(base_reads))}; host waits per steady tick (sync debug mode): with "
          f"sim {sorted(set(sim_syncs))}, without {sorted(set(base_syncs))}; census tick "
          f"+{census_extra} reads (the four columns), +{census_syncs} waits")
    print(f"census fetch + absorb {census_ms:.2f} ms, rebuild {recover_ms['rebuild']:.2f} ms, "
          f"verify {recover_ms['verify']:.2f} ms, apply_grid + verify "
          f"{recover_ms['apply_grid_verify']:.2f} ms (host clock)")
    if prof["busy_ms"] is None:
        print("sim profile: the trace recorded no device time (idle share not measured)")
    else:
        check(prof["k1"] == 1 and prof["k2"] == 1,
              f"profiled sim ticks ran K1 {prof['k1']} and K2 {prof['k2']} times per tick")
        print(f"sim profile (5 ticks): tick wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, idle share {prof['idle']:.4f}; K1 {prof['k1']} and "
              f"K2 {prof['k2']} per tick; top: " + "; ".join(
                  f"{k[:48]} {ms:.3f} ms x{c:g}" for k, ms, c in prof["top"]))
    return launches, kernels


# ---- the gateway (phase 6) ----------------------------------------------

# scripts/fanout_bench.py's config4: config/spatial_tpu_benchmark.json,
# moving entity channels with a storm of entities // 8; the
# standing-query plane and the sim plane at the gateway's defaults
# (4,096 query rows, 8,192 changed rows, 1,000 agents), 256 followers,
# 1,024 sensors and subscriptions at 33-200 ms. Cut to fit the script's
# time: 6,000 entities (the full claim is 50,000: BASELINE #4, the bench's
# --entities 50000; 20,000 before phase 11 joined, 12,000 before phase 12)
# and 12 ticks; the census every ticks // 3 (default
# 50) so censuses fall inside the run. ``--gateway ENTITIES TICKS`` runs
# the phase alone at another size.
GATEWAY_CONFIG = "config/spatial_tpu_benchmark.json"
GATEWAY_ENTITIES, GATEWAY_TICKS = 6_000, 12


def gateway_size(entities: int = GATEWAY_ENTITIES, ticks: int = GATEWAY_TICKS) -> dict:
    return dict(entities=entities, followers=256, sensors=1024, subscribers=256, ticks=ticks,
                census_every=max(1, ticks // 3), storms=(ticks // 4, 2 * ticks // 3))


GATEWAY_DEADLINE_S = 10.0  # device_step_deadline_s on both legs
GATEWAY_TICK_S = 0.033


class FixedClock:
    """``time.monotonic``/``monotonic_ns`` frozen while entered, moved
    only by ``advance``: both legs see the same channel times, engine
    clock and (zero) tick costs. Measurements use ``time.perf_counter``."""

    def __enter__(self):
        self.ns = 1_000 * 10**9
        self._saved = (time.monotonic, time.monotonic_ns)
        time.monotonic = lambda: self.ns / 1e9
        time.monotonic_ns = lambda: self.ns
        return self

    def __exit__(self, *exc):
        time.monotonic, time.monotonic_ns = self._saved
        return False

    def advance(self, seconds: float) -> None:
        self.ns += int(round(seconds * 1e9))


class GatewayConn:
    """A connection stub of the port (the surface channels touch) that
    folds every outbound message (type, channel, bytes) into a running
    digest instead of keeping it."""

    def __init__(self, P, conn_id: int, kind: str):
        self.P = P
        self.id = conn_id
        self.connection_type = P.types.ConnectionType[kind]
        self.state = P.types.ConnectionState.AUTHENTICATED
        self._closing = P.types.ConnectionState.CLOSING
        self.pit = f"pit{conn_id}"
        self.recover_handle = None
        self.spatial_subscriptions: dict = {}
        self.fsm_disallowed_counter = 0
        self.logger = P.logger.get_logger(f"stub.{conn_id}")
        self.digest = hashlib.sha256()
        self.count = 0
        self.frames = None  # a list keeps every (type, channel, body) sent

    def send(self, ctx) -> None:
        body = ctx.raw_body
        if body is None:
            body = ctx.msg.SerializeToString(deterministic=True) if ctx.msg is not None else b""
        self.digest.update(np.array([ctx.msg_type, ctx.channel_id, len(body)], np.int64).tobytes())
        self.digest.update(body)
        self.count += 1
        if self.frames is not None:
            self.frames.append((int(ctx.msg_type), int(ctx.channel_id), body))

    def is_closing(self) -> bool:
        return self.state >= self._closing

    def close(self, unexpected: bool = False) -> None:
        self.state = self._closing

    def should_recover(self) -> bool:
        return False

    def on_authenticated(self, pit: str) -> None:
        self.pit = pit

    def has_interest_in(self, ch_id: int) -> bool:
        return ch_id in self.spatial_subscriptions

    def flush(self) -> None:
        pass

    def has_authority_over(self, ch) -> bool:
        gch = self.P.channel.get_global_channel()
        return (gch is not None and gch.get_owner() is self) or ch.get_owner() is self

    def remote_addr(self):
        return ("127.0.0.1", 10000 + self.id)

    def remote_ip(self):
        return "127.0.0.1"

    def disconnect(self):
        pass




class EntitySim:
    """scripts/chaos_soak.py's EntitySim against one package's modules: the
    entities created at seeded positions over the world, a jitter step that
    walks an eighth of them +-8 m, a storm that marches ``storm_size`` into
    one cell, and its dispersal."""

    def __init__(self, P, ctl, entities: int, storm_size: int, rng):
        self.P, self.ctl, self.rng = P, ctl, rng
        self.entities, self.storm_size = entities, storm_size
        self.positions: dict[int, tuple[float, float]] = {}
        self.entity_ids: list[int] = []

    def world_xz(self) -> tuple:
        c = self.ctl
        return (c.world_offset_x + 1.0, c.world_offset_z + 1.0,
                c.world_offset_x + c.grid_width * c.grid_cols - 1.0,
                c.world_offset_z + c.grid_height * c.grid_rows - 1.0)

    def create_entities(self) -> None:
        P, ctl = self.P, self.ctl
        x0, z0, x1, z1 = self.world_xz()
        estart = P.settings.global_settings.entity_channel_id_start
        for i in range(self.entities):
            eid = estart + 1 + i
            x, z = self.rng.uniform(x0, x1), self.rng.uniform(z0, z1)
            info = P.controller.SpatialInfo(x, 0, z)
            cell_ch = P.channel.get_channel(ctl.get_channel_id(info))
            owner = cell_ch.get_owner()
            ch = P.channel.create_entity_channel(eid, owner)
            d = P.sim_pb2.SimEntityChannelData()
            d.state.entityId = eid
            d.state.transform.position.x = x
            d.state.transform.position.z = z
            ch.init_data(d, None)
            ch.spatial_notifier = ctl
            if owner is not None:
                P.sub.subscribe_to_channel(owner, ch, None)
            cell_ch.execute(lambda c, e=eid, dd=d: c.get_data_message().add_entity(e, dd))
            ctl.track_entity(eid, info)
            self.positions[eid] = (x, z)
            self.entity_ids.append(eid)

    def _move(self, eid: int, x: float, z: float) -> None:
        P, ctl = self.P, self.ctl
        ch = P.channel.get_channel(eid)
        if ch is None or ch.is_removing():
            return
        upd = P.sim_pb2.SimEntityChannelData()
        upd.state.entityId = eid
        upd.state.transform.position.x = x
        upd.state.transform.position.z = z

        def apply(c, u=upd):
            owner = c.get_owner()
            c.data.on_update(u, c.get_time(), owner.id if owner is not None else 0, ctl)

        ch.execute(apply)
        self.positions[eid] = (x, z)

    def jitter_step(self) -> None:
        x0, z0, x1, z1 = self.world_xz()
        for eid in self.rng.sample(self.entity_ids, max(1, len(self.entity_ids) // 8)):
            x, z = self.positions[eid]
            self._move(eid, min(max(x + self.rng.uniform(-8, 8), x0), x1),
                       min(max(z + self.rng.uniform(-8, 8), z0), z1))

    def storm_gather(self) -> list:
        c = self.ctl
        col, row = self.rng.randrange(c.grid_cols), self.rng.randrange(c.grid_rows)
        cx = c.world_offset_x + (col + 0.5) * c.grid_width
        cz = c.world_offset_z + (row + 0.5) * c.grid_height
        crowd = self.rng.sample(self.entity_ids, min(self.storm_size, len(self.entity_ids)))
        for eid in crowd:
            self._move(eid, cx + self.rng.uniform(-c.grid_width * 0.4, c.grid_width * 0.4),
                       cz + self.rng.uniform(-c.grid_height * 0.4, c.grid_height * 0.4))
        return crowd

    def disperse(self, crowd: list) -> None:
        x0, z0, x1, z1 = self.world_xz()
        for eid in crowd:
            self._move(eid, self.rng.uniform(x0, x1), self.rng.uniform(z0, z1))


class GatewayWorld:
    """Phase 6a's world on one device: the port's gateway on
    GATEWAY_CONFIG with real entity channels (created as
    scripts/chaos_soak.py's EntitySim creates them), stub connections
    for the master, the 9 servers and the clients, driven in a fixed
    order each GLOBAL tick: moves, entity channels, GLOBAL (the
    controller's guarded device step), spatial channels. A tick the
    device guard holds (no step served) fails the run unless ``HOLDS``."""

    HOLDS = False

    def __init__(self, dev: torch.device, clock: FixedClock, size: dict):
        from random import Random

        P = self.P = gateway_modules()
        self.dev, self.clock, self.size = dev, clock, size
        reset_gateway(P)
        s = P.settings.global_settings
        s.development = True
        s.spatial_device = dev.type
        s.sim_enabled = size.get("sim", True)
        s.sim_census_every_ticks = size["census_every"]
        s.device_step_deadline_s = size.get("deadline", GATEWAY_DEADLINE_S)
        for name, value in size.get("settings", {}).items():
            setattr(s, name, value)
        P.message.init_message_map()
        P.channel.init_channels()
        self._register_types()
        t0 = time.perf_counter()
        P.controller.init_spatial_controller(size.get("config", GATEWAY_CONFIG))
        self.load_s = time.perf_counter() - t0
        ctl = self.ctl = P.controller.get_spatial_controller()
        self.eng = ctl.engine
        check(self.eng.device.type == dev.type, f"the engine is on {self.eng.device}, not {dev}")
        self.conns: list[GatewayConn] = []
        self.handovers: list[list] = []
        self.step_ms: list[float] = []
        self.fanout_ms: list[float] = []
        self._wrap()
        rng = self.rng = Random(SEED + 6)
        self._servers()
        self._entities(rng)
        self._clients(rng)

    def _register_types(self) -> None:
        self.P.sim_models.register_sim_types()

    def conn(self, conn_id: int, kind: str) -> GatewayConn:
        c = GatewayConn(self.P, conn_id, kind)
        self.P.connection._all_connections[conn_id] = c
        self.conns.append(c)
        return c

    def _wrap(self) -> None:
        """Time the guarded device step and every fan-out decision pass
        (``tick_data`` of a channel with subscribers, the span the
        ``fanout_decision_latency`` histogram observes) on the host's
        perf_counter, since the run's monotonic clock is fixed."""
        guard, channel = self.P.guard.guard, self.P.channel
        dispatch, tick_data = guard._dispatch, channel.tick_data

        def timed_dispatch(engine):
            t0 = time.perf_counter()
            try:
                return dispatch(engine)
            finally:
                self.step_ms.append((time.perf_counter() - t0) * 1e3)

        def timed_tick_data(ch, now):
            if not ch.subscribed_connections:
                return tick_data(ch, now)
            t0 = time.perf_counter()
            tick_data(ch, now)
            self.fanout_ms.append((time.perf_counter() - t0) * 1e3)

        handover_list = self.eng.handover_list

        def recorded_handovers(result):
            rows = handover_list(result)
            self.handovers.append(rows)
            return rows

        guard._dispatch = timed_dispatch
        channel.tick_data = timed_tick_data
        self.eng.handover_list = recorded_handovers
        self._unwrap = lambda: (delattr(guard, "_dispatch"),
                                setattr(channel, "tick_data", tick_data))

    def _servers(self) -> None:
        P, ctl = self.P, self.ctl
        master = self.conn(1, "SERVER")
        gch = P.channel.get_global_channel()
        gch.set_owner(master)
        P.sub.subscribe_to_channel(master, gch, None)
        for i in range(ctl.server_cols * ctl.server_rows):
            server = self.conn(2 + i, "SERVER")
            ctx = P.message.MessageContext(msg_type=P.types.MessageType.CREATE_CHANNEL,
                                           msg=P.control_pb2.CreateChannelMessage(),
                                           connection=server)
            for ch in ctl.create_channels(ctx):
                P.sub.subscribe_to_channel(server, ch, None)
        chans = P.channel.all_channels()
        self.spatial = sorted(c for c, ch in chans.items()
                              if ch.channel_type == P.types.ChannelType.SPATIAL)
        check(len(self.spatial) == ctl.grid_cols * ctl.grid_rows, "the servers did not claim the world")

    def _entities(self, rng) -> None:
        sim = EntitySim(self.P, self.ctl, self.size["entities"], 0, rng)
        sim.create_entities()
        self.bounds = sim.world_xz()
        self.positions, self.entity_ids = sim.positions, sim.entity_ids
        self.entity_channels = [self.P.channel.get_channel(e) for e in self.entity_ids]

    def _clients(self, rng) -> None:
        P, ctl, size = self.P, self.ctl, self.size
        x0, z0, x1, z1 = self.bounds
        ops = P.ops
        m = ctl.grid_width / 2000.0  # extents in cells of the world's grid (config4's: 2,000 m)
        for i in range(size["followers"]):  # spheres and cones following entities
            client = self.conn(1000 + i, "CLIENT")
            eid = self.entity_ids[rng.randrange(len(self.entity_ids))]
            if i % 2:
                ctl.register_follow_interest(client, eid, ops.AOI_CONE, extent=(4000.0 * m, 0.0),
                                             direction=(1.0, 0.0), angle=0.6)
            else:
                ctl.register_follow_interest(client, eid, ops.AOI_SPHERE, extent=(3000.0 * m, 0.0))
        for i in range(size["sensors"]):  # static server sensors, box and sphere
            ctl.register_sensor(f"sensor{i}", kind=(ops.AOI_BOX, ops.AOI_SPHERE)[i % 2],
                                center=(rng.uniform(x0, x1), rng.uniform(z0, z1)),
                                extent=(rng.uniform(1500, 5000) * m, rng.uniform(1500, 5000) * m))
        for i in range(size["subscribers"]):  # plain subscriptions at 33-200 ms
            client = self.conn(5000 + i, "CLIENT")
            for cid in rng.sample(self.spatial, 4):
                opts = P.control_pb2.ChannelSubscriptionOptions(
                    fanOutIntervalMs=rng.choice((33, 50, 100, 200)), fanOutDelayMs=0)
                P.sub.subscribe_to_channel(client, P.channel.get_channel(cid), opts)

    def move(self, eid: int, x: float, z: float) -> None:
        P, ctl = self.P, self.ctl
        upd = P.sim_pb2.SimEntityChannelData()
        upd.state.entityId = eid
        upd.state.transform.position.x = x
        upd.state.transform.position.z = z

        def apply(c, u=upd):
            owner = c.get_owner()
            c.data.on_update(u, c.get_time(), owner.id if owner is not None else 0, ctl)

        P.channel.get_channel(eid).execute(apply)
        self.positions[eid] = (x, z)

    def drive(self, t: int) -> None:
        """Every entity moves each tick (a bounded random walk); on a
        storm tick entities // 8 gather into one cell, and they disperse
        two ticks later."""
        x0, z0, x1, z1 = self.bounds
        rng, ctl = self.rng, self.ctl
        storms = self.size["storms"]
        if t in storms:
            col, row = rng.randrange(ctl.grid_cols), rng.randrange(ctl.grid_rows)
            cx = ctl.world_offset_x + (col + 0.5) * ctl.grid_width
            cz = ctl.world_offset_z + (row + 0.5) * ctl.grid_height
            self.crowd = rng.sample(self.entity_ids, self.size["entities"] // 8)
            crowd = set(self.crowd)
            for eid in self.crowd:
                self.move(eid, cx + rng.uniform(-0.4, 0.4) * ctl.grid_width,
                          cz + rng.uniform(-0.4, 0.4) * ctl.grid_height)
        else:
            crowd = set(self.crowd) if t - 2 in storms else set()
            for eid in crowd:
                self.move(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
        for eid in self.entity_ids:
            if eid in crowd:
                continue
            x, z = self.positions[eid]
            self.move(eid, min(max(x + rng.uniform(-60, 60), x0), x1),
                      min(max(z + rng.uniform(-60, 60), z0), z1))

    def tick(self, t: int) -> dict:
        """One GLOBAL tick; returns what it produced (digests) and its
        costs. Host clock around the whole tick; device reads and host
        waits counted over it on the card."""
        P, eng = self.P, self.eng
        self.clock.advance(GATEWAY_TICK_S)
        self.drive(t)
        now = time.monotonic_ns()
        gch = P.channel.get_global_channel()
        chans = P.channel.all_channels()
        steps, crossings = len(self.step_ms), len(self.handovers)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        eng.last_result = None  # set again only by a step the guard serves
        with Reads() as reads:
            t0 = time.perf_counter()
            for ch in self.entity_channels:
                ch.tick_once(now)
            t1 = time.perf_counter()
            gch.tick_once(now)
            t2 = time.perf_counter()
            for cid in self.spatial:
                chans[cid].tick_once(now)
            t3 = time.perf_counter()
        result = eng.last_result
        check(result is not None or self.HOLDS, f"tick {t}: the engine did not step")
        q = undelivered = None
        census = False
        if result is not None:
            count, rows = eng.query_changed_rows(result)
            q = (count, digest([rows[: min(count, len(rows))]])[0])
            census = "sim_census" in result
            undelivered = eng.undelivered_slots(result)
        tables = hashlib.sha256()
        for cid in self.spatial:
            tables.update(chans[cid].get_data_message().SerializeToString(deterministic=True))
        guard, governor = P.guard.guard, P.overload.governor
        overflow = P.metrics.tpu_cell_overflow_total._value.get()
        delta = int(overflow - getattr(self, "overflow_total", overflow))
        self.overflow_total = overflow
        return dict(
            handovers=[r for rows in self.handovers[crossings:] for r in rows], q=q,
            tables=tables.hexdigest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns},
            guard=(guard.state.name, dict(guard.recovery_counts), dict(guard.failure_counts),
                   guard.held_ticks),
            served=result is not None, ladder=(int(governor.level), governor._level_floor),
            sim=digest(sim_columns(eng)) if eng._d_vel is not None else None, census=census,
            overflow=delta, undelivered=undelivered,
            tick_ms=(t3 - t0) * 1e3, global_ms=(t2 - t1) * 1e3,
            step_ms=self.step_ms[steps] if len(self.step_ms) > steps else None,
            reads=reads.count, syncs=reads.syncs)

    def census(self) -> dict:
        """The device soak's zero-loss invariants: every entity in exactly
        one spatial channel's table, tracked by the engine, and the
        placement ledger naming that channel (each list empty)."""
        chans = self.P.channel.all_channels()
        placed: dict[int, list] = {}
        for cid in self.spatial:
            for eid in chans[cid].get_data_message().entities:
                placed.setdefault(eid, []).append(cid)
        return dict(
            misplaced=[e for e in self.entity_ids if len(placed.get(e, ())) != 1],
            duplicated=[e for e, cids in placed.items() if len(cids) > 1],
            untracked=[e for e in self.entity_ids if self.eng.slot_of_entity(e) is None],
            ledger_off=[e for e in self.entity_ids
                        if self.ctl._data_cell.get(e) != placed.get(e, [None])[0]])

    def close(self) -> None:
        self._unwrap()
        reset_gateway(self.P)


def first_gateway_diff(a: dict, b: dict) -> Optional[str]:
    """The first observation of one tick that differs between the legs,
    with its detail (None when the tick is equal)."""
    for key in ("handovers", "tables", "q", "sim", "census", "guard", "served", "ladder",
                "overflow", "undelivered", "recovery", "elastic", "cell_msgs", "ledgers",
                "subs", "callbacks", "standing", "ran", "spans", "stages", "readbacks",
                "anomalies", "fires", "transfers", "governor", "sheds", "deferred", "counts",
                "engine", "placement", "agents", "trunk", "peers"):
        if a.get(key) != b.get(key):
            if key == "handovers":
                i = next((i for i, (x, y) in enumerate(zip(a[key], b[key])) if x != y),
                         min(len(a[key]), len(b[key])))
                return (f"handovers: {len(a[key])} vs {len(b[key])}, first differing "
                        f"row {i}: {a[key][i:i + 1]} vs {b[key][i:i + 1]}")
            return f"{key}: {str(a.get(key))[:200]} vs {str(b.get(key))[:200]}"
    for conn_id, got in a["sent"].items():
        if got != b["sent"].get(conn_id):
            return (f"connection {conn_id}'s outbound stream: {got[0]} messages "
                    f"(digest {got[1][:12]}) vs {b['sent'].get(conn_id)}")
    return None


def gateway_live_kernels(K, eng) -> None:
    """K1 and K2 against their plain versions on the gateway engine's
    live tensors (131,072 slots x 225 bins, 4,096 x 225 pairs), exact."""
    grid, qs = eng.grid, eng._d_queries
    pos, valid = eng._d_positions, eng._d_valid
    err1 = max_abs_diff(zip(K.assign_and_count(grid, pos, valid),
                            K.assign_and_count_plain(grid, pos, valid)))
    args = (qs.kind, qs.center, qs.extent, qs.direction, torch.cos(qs.angle))
    err2 = max_abs_diff(zip(K.aoi_tile(grid, *args), K.aoi_tile_plain(grid, *args)))
    check(err1 == 0 and err2 == 0, f"the gateway's live tensors: K1 |diff| {err1}, K2 {err2}")
    print(f"gateway path kernels on live tensors ({pos.shape[0]} slots x {grid.num_cells} bins, "
          f"{args[0].shape[0]} x {grid.num_cells} pairs): K1 and K2 exact against plain")


def profile_gateway(world: GatewayWorld, first: int, n: int = 5) -> dict:
    """n more gateway ticks under torch.profiler: device busy and idle
    share of a tick, K1/K2 launches per tick."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            world.tick(first + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = device_rows(prof, n)
    if not rows:
        return dict(wall_ms=wall, busy_ms=None, idle=None, k1=None, k2=None, top=[])
    busy = sum(r[1] for r in rows)
    return dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
                k1=sum(c for k, _, c in rows if "assign_count" in k),
                k2=sum(c for k, _, c in rows if "aoi_kernel" in k),
                top=sorted(rows, key=lambda r: -r[1])[:6])


def run_gateway_leg(K, dev, size: dict) -> tuple:
    """One leg of 6a: (per-tick observations, the leg's report). On the card
    it also holds K1 and K2 against their plain versions on the live tensors
    and profiles 5 more ticks."""
    t_leg = time.perf_counter()
    with FixedClock() as clock:
        world = GatewayWorld(dev, clock, size)
        report = dict(load_s=world.load_s)
        K.reset_launch_counts()
        obs = [world.tick(t) for t in range(size["ticks"])]
        report["launches"] = K.launch_counts()
        if dev.type == "cuda":
            gateway_live_kernels(K, world.eng)
            report["prof"] = profile_gateway(world, size["ticks"])
        report.update(agents=world.eng.agent_count(), fanout_ms=list(world.fanout_ms))
        world.close()
        del world
    report["secs"] = time.perf_counter() - t_leg
    return obs, report


def phase_gateway_lockstep(K, dev, cpu_leg: "CpuLeg") -> dict:
    """6a: the port's gateway on the card against a lockstep CPU run of it
    at the same size (``cpu_leg.size``) in ``cpu_leg``'s child, tick for
    tick. Returns K1/K2 launches on this path."""
    size = cpu_leg.size
    ticks = size["ticks"]
    t_phase = time.perf_counter()
    try:
        card, rc = run_gateway_leg(K, dev, size)
        cpu, rp = cpu_leg.result()
    finally:
        cpu_leg.close()
    launches, prof = rc["launches"], rc["prof"]
    for name, count in launches.items():
        check(count == ticks, f"kernel {name} launched {count} times in {ticks} gateway ticks")
    check(len(card) == len(cpu), f"6a: {len(card)} card and {len(cpu)} cpu ticks")
    for t in range(ticks):
        where = first_gateway_diff(card[t], cpu[t])
        check(where is None, f"gateway tick {t}: cuda and cpu differ: {where}")
    agents, fanout_ms, cpu_fanout = rc["agents"], rc["fanout_ms"], rp["fanout_ms"]

    census_ticks = [t for t, o in enumerate(card) if o["census"]]
    steady = [t for t in range(1, ticks) if t not in census_ticks]
    check(census_ticks, "no census fell inside the run")
    reads = sorted({card[t]["reads"] for t in steady})
    check(reads == [2], f"device reads per steady gateway tick {reads}, not 2")
    extra = sorted({card[t]["reads"] - 2 for t in census_ticks})
    check(extra == [4], f"census ticks read {extra} more than a steady tick, not the 4 columns")
    handovers = sum(len(o["handovers"]) for o in card)
    check(handovers > 0, "no handover in the run")
    host_share = [1 - o["step_ms"] / o["tick_ms"] for o in card[1:]]
    print(f"gateway lockstep: {ticks} GLOBAL ticks of {size['entities']} moving entity channels "
          f"on {GATEWAY_CONFIG} (storms of {size['entities'] // 8} at ticks {size['storms']}, "
          f"{size['followers']} followers, {size['sensors']} sensors, {size['subscribers']} "
          f"subscribers, the sim plane's {agents} agents, census ticks {census_ticks}) on cuda equal "
          f"the CPU leg tick for tick: handovers ({handovers}), entity tables, every "
          f"connection's outbound stream, changed query rows, sim columns bit for bit; "
          f"launches {launches}; device_step_deadline_s {GATEWAY_DEADLINE_S} on both legs; "
          f"phase {time.perf_counter() - t_phase:.1f} s (card leg {rc['secs']:.1f} s, cpu leg "
          f"{rp['secs']:.1f} s in a --cpu-leg child, load_config {rc['load_s']:.2f} s)")
    for label, legs in (("cuda", card), ("cpu", cpu)):
        print(f"gateway per tick on {label} (ticks 1-{ticks - 1}): tick "
              f"{tick_stats([o['tick_ms'] for o in legs[1:]])}; GLOBAL tick "
              f"{tick_stats([o['global_ms'] for o in legs[1:]])}; guarded device step "
              f"{tick_stats([o['step_ms'] for o in legs[1:]])}; host share "
              f"{tick_stats([1 - o['step_ms'] / o['tick_ms'] for o in legs[1:]]).replace(' ms', '')}")
    print(f"fan-out decision (tick_data of a channel with subscribers, perf_counter): cuda "
          f"{tick_stats(fanout_ms)} over {len(fanout_ms)} passes; cpu {tick_stats(cpu_fanout)}")
    print(f"gateway reads per steady tick {reads} (the consume and changed-rows blobs), census "
          f"tick +{extra[0]}; host waits per steady tick "
          f"{sorted({card[t]['syncs'] for t in steady})}, census tick "
          f"{sorted({card[t]['syncs'] for t in census_ticks})}; host share of a card tick "
          f"median {statistics.median(host_share):.4f}")
    if prof["busy_ms"] is None:
        print("gateway profile: the trace recorded no device time (idle share not measured)")
    else:
        check(prof["k1"] == 1 and prof["k2"] == 1,
              f"profiled gateway ticks ran K1 {prof['k1']} and K2 {prof['k2']} times per tick")
        print(f"gateway profile (5 ticks): tick wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, idle share {prof['idle']:.4f}; top: " + "; ".join(
                  f"{k[:48]} {ms:.3f} ms x{c:g}" for k, ms, c in prof["top"]))
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_gateway_live(dev_args=(), deadline_s: float = 180.0) -> None:
    """6b: ``python -m channeld_tpu_torch`` as a child on the card, driven
    over loopback TCP: a master and 9 servers claim the world, a server
    sets a client's follow interest on an entity, the entity crosses
    from one server's cell into another's; both servers get the
    handover and the client its interest update; SIGTERM exits 0."""
    import os
    import shutil
    import signal
    import tempfile

    from channeld_tpu_torch.client import Client
    from channeld_tpu_torch.core.types import ChannelDataAccess, ChannelType, MessageType
    from channeld_tpu_torch.models import sim_pb2
    from channeld_tpu_torch.protocol import control_pb2, spatial_pb2
    from channeld_tpu_torch.utils.anyutil import pack_any

    sport, cport = free_port(), free_port()
    scratch = tempfile.mkdtemp(prefix="gateway-")
    log_path = os.path.join(scratch, "gateway.log")
    log_fd = os.open(log_path, os.O_WRONLY | os.O_CREAT, 0o600)
    cmd = [sys.executable, "-m", "channeld_tpu_torch", "-dev", "-loglevel", "0",
           "-profilepath", scratch,
           "-sn", "tcp", "-sa", f"127.0.0.1:{sport}", "-cn", "tcp", "-ca", f"127.0.0.1:{cport}",
           "-mport", "0", "-cfsm", "config/client_authoritative_fsm.json",
           "-scc", GATEWAY_CONFIG, "-imports", "channeld_tpu_torch.models.sim", *dev_args]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, stdout=log_fd, stderr=subprocess.STDOUT)
    os.close(log_fd)
    clients = []

    def log() -> str:
        with open(log_path) as f:
            return f.read()

    def until(cond, what: str, timeout: float):
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            for c in clients:
                c.tick(timeout=0.01)
            if cond():
                return
            check(child.poll() is None, f"gateway child exited ({child.returncode}) while "
                  f"waiting for {what}: {log()[-2000:]}")
            time.sleep(0.02)
        raise PhaseFailed(f"gateway child: no {what} within {timeout} s; log: {log()[-2000:]}")

    def connect(name: str, port: int) -> Client:
        c = Client(f"127.0.0.1:{port}")
        clients.append(c)
        c.auth(login_token=name, pit=name)
        c.flush()
        until(lambda: c.id != 0, f"{name}'s auth", 20)
        return c

    def record(c: Client, msg_type: int) -> list:
        box: list = []
        c.add_message_handler(msg_type, lambda _c, ch, m: box.append((ch, m)))
        return box

    try:
        until(lambda: "listening for SERVER" in log(), "server listener", deadline_s)
        ready_s = time.perf_counter() - t0
        text = log()
        check("spatial engine on cuda" in text or dev_args, "the child's engine is not on cuda")
        check("kernels built and warmed in load_config" in text,
              "the child did not build and warm its kernels in load_config")
        master = connect("master", sport)
        created = record(master, MessageType.CREATE_CHANNEL)
        master.send(0, 0, MessageType.CREATE_CHANNEL,
                    control_pb2.CreateChannelMessage(channelType=ChannelType.GLOBAL))
        until(lambda: created, "GLOBAL's creation", 20)
        until(lambda: "listening for CLIENT" in log(), "client listener", 20)
        servers, ready, handovers = [], [], []
        for i in range(9):
            s = connect(f"spatial{i}", sport)
            ready.append(record(s, MessageType.SPATIAL_CHANNELS_READY))
            handovers.append(record(s, MessageType.CHANNEL_DATA_HANDOVER))
            s.send(0, 0, MessageType.CREATE_CHANNEL, control_pb2.CreateChannelMessage(
                channelType=ChannelType.SPATIAL,
                subOptions=control_pb2.ChannelSubscriptionOptions(
                    dataAccess=ChannelDataAccess.WRITE_ACCESS)))
            servers.append(s)
        until(lambda: all(ready), "SPATIAL_CHANNELS_READY on every server", 30)
        client = connect("client", cport)
        subs = record(client, MessageType.SUB_TO_CHANNEL)
        unsubs = record(client, MessageType.UNSUB_FROM_CHANNEL)
        # Server 0 (cells of columns 0-4) spawns an entity in column 4
        # and has the client follow it with a 1,500 m sphere.
        start, eid = 0x10000, 0x80000 + 1
        d = sim_pb2.SimEntityChannelData()
        d.state.entityId = eid
        d.state.transform.position.x, d.state.transform.position.z = -5100.0, -14000.0
        servers[0].send(0, 0, MessageType.CREATE_ENTITY_CHANNEL,
                        spatial_pb2.CreateEntityChannelMessage(entityId=eid, data=pack_any(d)))
        q = spatial_pb2.SpatialInterestQuery()
        q.sphereAOI.center.x, q.sphereAOI.center.z, q.sphereAOI.radius = -5100.0, -14000.0, 1500.0
        servers[0].send(start + 4, 0, MessageType.UPDATE_SPATIAL_INTEREST,
                        spatial_pb2.UpdateSpatialInterestMessage(connId=client.id, query=q,
                                                                 followEntityId=eid))
        until(lambda: {ch for ch, _ in subs} >= {start + 4, start + 5},
              "the client's follow interest (columns 4 and 5)", 20)
        # The entity crosses into column 5 (server 1) and on: the interest
        # moves to columns 5-6.
        upd = sim_pb2.SimEntityChannelData()
        upd.state.entityId = eid
        upd.state.transform.position.x, upd.state.transform.position.z = -3100.0, -14000.0
        servers[0].send(eid, 0, MessageType.CHANNEL_DATA_UPDATE,
                        control_pb2.ChannelDataUpdateMessage(data=pack_any(upd)))
        until(lambda: handovers[0] and handovers[1], "the handover on servers 0 and 1", 20)
        until(lambda: any(ch == start + 6 for ch, _ in subs) and unsubs,
              "the client's interest update after the crossing", 20)
        child.send_signal(signal.SIGTERM)
        try:
            code = child.wait(timeout=20)
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"the gateway child did not exit within 20 s of SIGTERM: {log()[-2000:]}")
        check(code == 0, f"the gateway child exited {code} on SIGTERM: {log()[-2000:]}")
        print(f"gateway live: python -m channeld_tpu_torch on "
              f"{'cuda' if not dev_args else ' '.join(dev_args)} listening in {ready_s:.1f} s "
              f"(engine built and warmed in load_config), master + 9 servers claimed "
              f"{GATEWAY_CONFIG} over TCP, the crossing handed entity {eid} from server 0 to "
              f"server 1 ({len(handovers[0])} + {len(handovers[1])} handover messages), the "
              f"follower's interest moved ({len(subs)} subs, {len(unsubs)} unsubs); SIGTERM exit 0")
    finally:
        for c in clients:
            c.disconnect()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
        shutil.rmtree(scratch, ignore_errors=True)


def phase_gateway_threads(K, engine_mod, ops, dev, ticks: int = 100) -> None:
    """6c: two engines ticked from two threads on one card (a watchdog's
    zombie worker and the fresh one share K1's zero-ahead counts buffer
    on the same stream); every tick's counts equal the plain version."""
    import threading

    grid = ops.GridSpec(**BENCH_GRID)
    engines, errors = [], []
    for i in range(2):
        eng = engine_mod.SpatialEngine(grid, entity_capacity=1 << 17, query_capacity=64,
                                       device=dev)
        rng = np.random.default_rng(SEED + 60 + i)
        pos = rng.uniform(-15000.0, 15000.0, (20_000, 2))
        for j, (x, z) in enumerate(pos):
            eng.add_entity(0x80000 + j, float(x), 0.0, float(z))
        eng.warmup()
        engines.append(eng)
    barrier = threading.Barrier(2)

    def work(i: int, eng) -> None:
        rng = np.random.default_rng(SEED + 70 + i)
        try:
            with torch.cuda.device(dev):
                barrier.wait(timeout=60)
                for t in range(ticks):
                    for j in rng.integers(0, 20_000, 500):
                        x, z = rng.uniform(-15000.0, 15000.0, 2)
                        eng.update_entity(0x80000 + int(j), float(x), 0.0, float(z))
                    out = eng.tick(now_ms=33 * t)
                    want = K.assign_and_count_plain(grid, eng._d_positions, eng._d_valid)[1]
                    if not torch.equal(out["cell_counts"], want):
                        errors.append((i, t))
        except Exception as e:  # reported by the main thread
            errors.append((i, repr(e)))

    K.reset_launch_counts()
    threads = [threading.Thread(target=work, args=(i, e)) for i, e in enumerate(engines)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not any(th.is_alive() for th in threads), "a ticking thread did not finish")
    check(not errors, f"K1 counts differ from plain across threads: {errors[:4]}")
    launches = K.launch_counts()["assign_count"]
    check(launches == 2 * ticks, f"K1 launched {launches} times, not {2 * ticks}")
    print(f"gateway threads: two engines ticked {ticks} times each from two threads on one "
          f"card; K1's counts equal the plain version on every tick ({launches} launches)")


def phase_sidecar(service, dev) -> None:
    if not (importlib.util.find_spec("grpc") and importlib.util.find_spec("google.protobuf")):
        print("sidecar round trip: not run (grpc/protobuf not installed)")
        return
    from channeld_tpu_torch.ops.service_pb2 import StepRequest

    server, _, port = service.create_server(port=0, auth_token="", device=dev)
    server.start()
    client = service.SpatialDecisionClient(f"127.0.0.1:{port}")
    try:
        client.configure(worldOffsetX=-150, worldOffsetZ=-150, gridWidth=100,
                         gridHeight=100, gridCols=3, gridRows=3,
                         entityCapacity=64, queryCapacity=8, subCapacity=8)
        req = StepRequest(nowMs=10)
        req.updates.add(entityId=0x80001, x=-100, y=0, z=-100)
        req.queries.add(connId=5, kind=1, centerX=0, centerZ=0, extentX=40)
        resp = client.step(req)
        check(list(resp.cellCounts)[0] == 1, "sidecar round trip: wrong counts")
        check({ir.connId: dict(zip(ir.cells, ir.dists)) for ir in resp.interests}
              == {5: {4: 0}}, "sidecar round trip: wrong interest")
        print("sidecar round trip: Configure + Step over gRPC on cuda ok")
    finally:
        client.close()
        server.stop(None)


# ---- the multi-device planes (phase 7) ------------------------------------

# 7a/7b: the sidecar's width (1<<17 slots, 4,096 queries of every kind,
# 65,536 subscription slots, 4,096 handover rows) on BENCH_GRID over 8
# shards; 7c: phase 6a's world on a mesh, cut to 5,000 entities x 12 ticks.
MESH_SHARDS = 8
MESH_SIZE = dict(entities=100_000, slots=1 << 17, queries=4096, subs=1 << 16, rows=4096,
                 ticks=30, burst=10, storm=20)
MESH_GATEWAY = dict(entities=5_000, ticks=12)


def mesh_cards(n: int = MESH_SHARDS) -> list:
    """n shards over the cards present, round-robin: a real multi-card
    mesh where there are 2 or more, shards sharing one card otherwise."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def sync_cards() -> None:
    """Wait for every card (``torch.cuda.synchronize()`` waits for the
    current one only)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_note() -> str:
    count = torch.cuda.device_count()
    return (f"{count} cards: a real multi-card mesh" if count >= 2
            else "1 card: the shards were virtual, all on cuda:0")


class MeshLoad:
    """Phase 7a's seeded traffic on BENCH_GRID, in slot arrays: 100,000
    moving entities in 1<<17 slots (pinned NaN/±inf/1e20/boundary rows;
    50 leave and 50 join per tick), 4,096 queries of every kind with a
    spots table, 65,536 subscriptions at 33-200 ms. Tick ``burst`` moves
    entities // 50 (2,000) of shard 2's entities one cell over (past its 512-row
    budget; the others stay under theirs); tick ``storm`` gathers
    entities // 8 into cell 7 (block 0 of the cells plane, past its
    bucket), and they disperse two ticks later."""

    WORLD = 30000.0

    def __init__(self, rng: np.random.Generator, size: dict = MESH_SIZE):
        self.rng, self.size = rng, size
        n, cap = size["entities"], size["slots"]
        lo = self.lo = BENCH_GRID["offset_x"]
        self.pos = np.zeros((cap, 3), np.float32)
        self.pos[:n] = rng.uniform(lo, lo + self.WORLD, (n, 3))
        self.pos[:, 1] = 0.0
        self.valid = np.zeros(cap, bool)
        self.valid[:n] = True
        speed, heading = rng.uniform(0, 60, cap), rng.uniform(0, 2 * np.pi, cap)
        self.vel = np.stack([speed * np.cos(heading), np.zeros(cap), speed * np.sin(heading)],
                            axis=1).astype(np.float32)
        self.pos[:6, 0] = [np.nan, np.inf, -np.inf, 1e20, -15000.0, 1000.0]
        self.pos[:6, 2] = [0.0, 0.0, 0.0, 0.0, -13000.0, np.nan]
        self.vel[:6] = 0.0
        grid = NS(**BENCH_GRID)
        c = grid.cols * grid.rows
        self.grid = grid
        q = size["queries"]
        kind, center, extent, direction, angle = (
            t.numpy() for t in query_inputs(grid, q, rng, "cpu"))
        spot = np.full((q, c), -1, np.int32)
        for row in np.nonzero(kind == 4)[0]:
            cells = rng.choice(c, int(rng.integers(1, 8)), replace=False)
            spot[row, cells] = rng.integers(0, 6, cells.size)
        self.queries = (kind, center, extent, direction, angle, spot)
        s = size["subs"]
        self.subs = (rng.integers(0, 200, s).astype(np.int32),
                     rng.integers(33, 201, s).astype(np.int32), rng.random(s) < 0.9)
        self.crowd = None

    def wrap(self, v):
        with np.errstate(invalid="ignore"):
            return ((v - self.lo) % self.WORLD + self.lo).astype(np.float32)

    def step(self, t: int):
        """(positions, valid) of tick t."""
        r, size, cap = self.rng, self.size, self.size["slots"]
        live = np.nonzero(self.valid)[0]
        live = live[live >= 6]
        moved = self.pos[live] + self.vel[live]
        self.pos[live, 0], self.pos[live, 2] = self.wrap(moved[:, 0]), self.wrap(moved[:, 2])
        shard = cap // MESH_SHARDS
        if t == size["burst"]:
            mine = live[(live >= 2 * shard) & (live < 3 * shard)]
            burst = r.choice(mine, size["entities"] // 50, replace=False)
            self.pos[burst, 0] = self.wrap(self.pos[burst, 0] + 2000.0)
        if t == size["storm"]:
            cx, cz = self.lo + 7.5 * 2000.0, self.lo + 0.5 * 2000.0  # cell 7: block 0
            self.crowd = r.choice(live, size["entities"] // 8, replace=False)
            self.pos[self.crowd, 0] = cx + r.uniform(-800, 800, self.crowd.size)
            self.pos[self.crowd, 2] = cz + r.uniform(-800, 800, self.crowd.size)
        if t == size["storm"] + 2:
            self.pos[self.crowd, 0] = r.uniform(self.lo, self.lo + self.WORLD, self.crowd.size)
            self.pos[self.crowd, 2] = r.uniform(self.lo, self.lo + self.WORLD, self.crowd.size)
        if t > 0:  # churn: 50 leave, 50 join in free slots
            self.valid[r.choice(live, 50, replace=False)] = False
            free = np.nonzero(~self.valid)[0]
            join = r.choice(free[free >= 6], 50, replace=False)
            self.valid[join] = True
            self.pos[join, 0::2] = r.uniform(self.lo, self.lo + self.WORLD, (50, 2))
        return self.pos.copy(), self.valid.copy()


def flat(x) -> torch.Tensor:
    """A step output as one CPU tensor (per-shard lists concatenated)."""
    if isinstance(x, (list, tuple)):
        return torch.cat([p.cpu() for p in x])
    return x.cpu()


def mesh_diffs(card: dict, cpu: dict, label: str) -> list[str]:
    """Every output of a mesh step that differs between the card and the
    CPU leg, with where."""
    out = []
    for key, value in cpu.items():
        a, b = flat(card[key]), flat(value)
        if a.shape != b.shape or not torch.equal(a, b):
            where = ((a != b).nonzero()[:3].tolist() if a.shape == b.shape
                     else f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
            out.append(f"{label}: {key} differs at {where}")
    return out


class MeshStepRun:
    """One mesh configuration of phase 7a on one device kind: the step
    function and the committed state (prev_cell per shard, last fan-out)
    advanced from its own results."""

    def __init__(self, grid, mesh, kind: str, bucket: int, per_shard: int):
        from channeld_tpu_torch.parallel import mesh as PM
        from channeld_tpu_torch.parallel import spatial_alltoall as PA

        self.mesh, self.kind = mesh, kind
        if kind == "cells":
            self.step = PA.build_cell_serving_step(grid, mesh, bucket, per_shard, True)
            self.drive = PA.cell_serving_spatial_step
        else:
            self.step = PM.build_sharded_step(grid, mesh, per_shard, True)
            self.drive = PM.sharded_spatial_step
        self.prev = None
        self.last = None

    def tick(self, load_arrays, now_ms: int) -> dict:
        pos, valid, queries, subs = load_arrays
        dev = self.mesh.replica
        if self.prev is None:
            self.prev = torch.full((pos.shape[0],), -1, dtype=torch.int32, device=dev)
            self.last = subs[0]
        out = self.drive(self.step, pos, self.prev, valid, queries,
                         (self.last, subs[1], subs[2]), now_ms)
        self.prev, self.last = out["committed_prev"], out["new_last_fanout_ms"]
        return out


def mesh_inputs(ops, load: MeshLoad, pos, valid, dev):
    kind, center, extent, direction, angle, spot = load.queries
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    queries = ops.QuerySet(t(kind), t(center), t(extent), t(direction), t(angle), t(spot))
    return t(pos), t(valid), queries, tuple(t(a) for a in load.subs)


def mesh_kernel_entries(K, ops, grid, pos, valid, queries, n_shards: int) -> dict:
    """K1 and K2 at one shard's shapes of this path (16,384 slots x 225
    bins; 4,096 queries x one 29-cell block, the last running past the
    grid), each exact against its plain version, with times and bounds."""
    from channeld_tpu_torch.parallel.spatial_alltoall import cells_per_shard

    n = pos.shape[0] // n_shards
    c = grid.num_cells
    p, v = pos[:n].contiguous(), valid[:n].contiguous()
    err1 = max_abs_diff(zip(K.assign_and_count(grid, p, v), K.assign_and_count_plain(grid, p, v)))
    check(err1 == 0, f"K1 at one shard's shape differs from plain (max |diff| {err1})")
    blk = cells_per_shard(grid, n_shards)
    base = (n_shards - 1) * blk
    args = (queries.kind, queries.center, queries.extent, queries.direction,
            torch.cos(queries.angle))
    q = args[0].shape[0]
    err2 = max_abs_diff(zip(K.aoi_tile(grid, *args, base, blk),
                            K.aoi_tile_plain(grid, *args, base, blk)))
    check(err2 == 0, f"K2 on the last block differs from plain (max |diff| {err2})")
    ids = [i for i in range(base, base + blk) if i < c]
    axes = len({i % grid.cols for i in ids}) + len({i // grid.cols for i in ids})
    b1, by1 = bound_ms(p.numel() * 4 + n + 4 * n + 4 * c, ASSIGN_OPS_PER_SLOT * n)
    b2, by2 = bound_ms(q * (4 + 3 * 8 + 4) + q * blk * 5,
                       AOI_OPS_PER_PAIR * q * len(ids) + AOI_OPS_PER_AXIS * q * axes)
    out = {
        "assign_count": dict(
            shape=f"{n} slots x {c} bins per shard", max_abs_err=err1, bound_ms=b1,
            bound_by=by1, ms=queued_ms(K.prepare_assign_count(grid, p, v).run),
            plain_ms=median_ms(lambda: K.assign_and_count_plain(grid, p, v)), library_ms=None),
        "aoi": dict(
            shape=f"{q} x {blk} pairs per shard (cell_base {base}, ids to {base + blk - 1} "
                  f"of {c})", max_abs_err=err2, bound_ms=b2, bound_by=by2,
            ms=queued_ms(K.prepare_aoi(grid, *args, base, blk).run),
            plain_ms=median_ms(lambda: K.aoi_tile_plain(grid, *args, base, blk), reps=20,
                               warmup=2), library_ms=None),
    }
    for name, e in out.items():
        print(f"{name} at the mesh path's per-shard shape ({e['shape']}): exact; alone "
              f"{e['ms']:.4f} ms (events, bare launches), plain {e['plain_ms']:.4f} ms, "
              f"bound {e['bound_ms']:.5f} ms ({e['bound_by']})")
    return out


class StepTicker:
    """A mesh run ticked by profile_ticks (the tick's inputs re-sent)."""

    def __init__(self, run: MeshStepRun, inputs):
        self.run, self.inputs = run, inputs

    def tick(self, t: int) -> None:
        self.run.tick(self.inputs, 1000 + 33 * t)


def phase_mesh_steps(K, ops) -> tuple[dict, dict]:
    """7a: the entity-sharded step on 8 shards and on a (2, 4) mesh, the
    cells serving step on 8 shards with a bucket the storm overflows, on
    the card, each tick against the same mesh on the CPU (exactly) and,
    on ticks without overflow, against the single-device step on the
    card fed the same inputs; then the halo plane at the sim world's
    grid against the dense computation. Returns (launches on this path,
    the kernels' per-shard entries)."""
    from channeld_tpu_torch.parallel import mesh as PM
    from channeld_tpu_torch.parallel import spatial_alltoall as PA

    grid = ops.GridSpec(**BENCH_GRID)
    cards, cpus = mesh_cards(), [torch.device("cpu")] * MESH_SHARDS
    dev = cards[0]
    per_shard = -(-MESH_SIZE["rows"] // MESH_SHARDS)
    first = MeshLoad(np.random.default_rng(SEED + 7))
    bucket = storm_bucket(ops, grid, first.pos, first.valid, MESH_SIZE["entities"] // 8)
    configs = [("entities 8", lambda d: PM.make_mesh(d), "entities"),
               ("entities 2x4", lambda d: PM.make_mesh_2d(2, d), "entities"),
               ("cells 8", lambda d: PA.make_space_mesh(d), "cells")]
    ticks = MESH_SIZE["ticks"]
    launches = {"assign_count": 0, "aoi": 0}
    mismatches: list[str] = []
    t_phase = time.perf_counter()
    kernels = None
    for label, make, kind in configs:
        load = MeshLoad(np.random.default_rng(SEED + 7))
        card = MeshStepRun(grid, make(cards), kind, bucket, per_shard)
        cpu = MeshStepRun(grid, make(cpus), kind, bucket, per_shard)
        host_ms, event_ms, single_ms, compared, overflow_ticks = [], [], [], 0, []
        for t in range(ticks):
            pos, valid = load.step(t)
            now = 1000 + 33 * t
            ins = mesh_inputs(ops, load, pos, valid, dev)
            prev_in = [p.clone() for p in card.prev] if card.prev is not None else None
            last_in = card.last.clone() if card.last is not None else ins[3][0]
            sync_cards()
            K.reset_launch_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = card.tick(ins, now)
            end.record()
            sync_cards()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(start.elapsed_time(end))
            got = K.launch_counts()
            want = {"assign_count": MESH_SHARDS, "aoi": MESH_SHARDS if kind == "cells" else 1}
            if got != want:
                mismatches.append(f"{label} tick {t}: launches {got}, not {want}")
            for k in launches:
                launches[k] += got[k]
            ref = cpu.tick(mesh_inputs(ops, load, pos, valid, "cpu"), now)
            mismatches += mesh_diffs(out, ref, f"{label} tick {t}")
            # The single-device step on the same inputs: equal wherever
            # nothing overflowed (no shard past its rows, no bucket full).
            prev_single = (torch.cat([p.to(dev) for p in prev_in]) if prev_in is not None
                           else torch.full((pos.shape[0],), -1, dtype=torch.int32, device=dev))
            t1 = time.perf_counter()
            single = ops.spatial_step(grid, ins[0], prev_single, ins[1], ins[2],
                                      (last_in, ins[3][1], ins[3][2]), MESH_SIZE["rows"], now)
            sync_cards()
            single_ms.append((time.perf_counter() - t1) * 1e3)
            # What does not depend on a budget is always equal; the rows
            # and the committed baseline only while no shard is past its
            # rows, the counts only while no bucket is full.
            keys = ["cell_of", "interest", "dist", "due", "new_last_fanout_ms"]
            rows_over = bool((out["handover_counts"].cpu() > per_shard).any())
            bucket_over = kind == "cells" and int(out["overflow"].sum()) > 0
            if rows_over or bucket_over:
                overflow_ticks.append(t)
            if not bucket_over:
                keys.append("cell_counts")
            if not rows_over:
                keys.append("committed_prev")
                count, rows = PM.merge_handover_shards(out["handover_counts"], out["handovers"])
                want_rows = single["handovers"][: int(single["handover_count"])].cpu().numpy()
                if count != int(single["handover_count"]) or rows.tolist() != want_rows.tolist():
                    mismatches.append(f"{label} tick {t}: handovers differ from the single-device "
                                      f"step ({count} vs {int(single['handover_count'])})")
            compared += not (rows_over or bucket_over)
            for key in keys:
                if not torch.equal(flat(out[key]), single[key].cpu()):
                    mismatches.append(f"{label} tick {t}: {key} differs from the single-device "
                                      f"step")
        for line in mismatches[:60]:
            print(f"MISMATCH {line}")
        check(not mismatches, f"7a {label}: {len(mismatches)} mismatches (printed above)")
        check(overflow_ticks, f"7a {label}: no tick overflowed")
        check(compared >= MESH_SIZE["burst"], f"7a {label}: only {compared} ticks without "
              f"overflow to compare whole with the single-device step")
        # K1 and K2 on the last tick's live shard tensors, against plain.
        shards = card.mesh.size
        for s, (p, v) in enumerate(zip(torch.chunk(ins[0], shards), torch.chunk(ins[1], shards))):
            err = max_abs_diff(zip(K.assign_and_count(grid, p, v),
                                   K.assign_and_count_plain(grid, p, v)))
            check(err == 0, f"7a {label}: K1 on shard {s}'s live tensors differs from plain")
        if kind == "cells":
            blk = PA.cells_per_shard(grid, shards)
            q = ins[2]
            args = (q.kind, q.center, q.extent, q.direction, torch.cos(q.angle))
            for s in range(shards):
                err = max_abs_diff(zip(K.aoi_tile(grid, *args, s * blk, blk),
                                       K.aoi_tile_plain(grid, *args, s * blk, blk)))
                check(err == 0, f"7a {label}: K2 on block {s}'s live tensors differs from plain")
            kernels = mesh_kernel_entries(K, ops, grid, ins[0], ins[1], ins[2], shards)
        prof = profile_ticks(StepTicker(card, ins), ticks)

        print(f"7a {label} ({kind} plane, mesh {card.mesh.shape}): {ticks} ticks of "
              f"{MESH_SIZE['entities']} moving entities on cuda equal the same mesh on the CPU "
              f"on every output; equal to the single-device step on every output of the "
              f"{compared} ticks without overflow, and on all but the rows, baseline and (bucket "
              f"full) counts of the overflow ticks {overflow_ticks}; launches per tick K1 "
              f"{MESH_SHARDS}, K2 {MESH_SHARDS if kind == 'cells' else 1}; step host "
              f"{tick_stats(host_ms[1:])}, events {tick_stats(event_ms[1:])}; single-device step host "
              f"{tick_stats(single_ms[1:])}")
        if prof["busy_ms"] is None:
            print(f"7a {label} profile: the trace recorded no device time (not measured)")
        else:
            print(f"7a {label} profile (5 ticks): tick wall {prof['wall_ms']:.2f} ms, device "
                  f"busy {prof['busy_ms']:.3f} ms, idle share {prof['idle']:.4f}; K1 "
                  f"{prof['k1']:g} and K2 {prof['k2']:g} per tick; top: " + "; ".join(
                      f"{k[:40]} {ms:.3f} ms x{c:g}" for k, ms, c in prof["top"]))
    phase_halo_plane(K, ops, cards)
    print(f"7a: {time.perf_counter() - t_phase:.1f} s; {mesh_note()}")
    return launches, kernels


def phase_halo_plane(K, ops, cards, ticks: int = 3) -> None:
    """7a, the ingest plane with ring halos: 100,000 entities on the sim
    world's 64x64 grid of 100 m cells (8 rows per shard), on the card
    against the CPU (exactly) and against the dense computation."""
    from channeld_tpu_torch.parallel import spatial_alltoall as PA

    grid = ops.GridSpec(**SIM_GRID)
    rng = np.random.default_rng(SEED + 8)
    cap, n = MESH_SIZE["slots"], MESH_SIZE["entities"]
    pos = np.zeros((cap, 3), np.float32)
    pos[:n, 0::2] = rng.uniform(0, 6400, (n, 2))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    ids = np.arange(cap, dtype=np.int32) + 0x80000
    bucket = cap // MESH_SHARDS // 4  # twice a shard's even share per block
    card = PA.build_cell_sharded_step(grid, PA.make_space_mesh(cards), bucket)
    cpu = PA.build_cell_sharded_step(grid, PA.make_space_mesh(["cpu"] * MESH_SHARDS), bucket)
    launches = {"assign_count": 0, "aoi": 0}
    for t in range(ticks):
        pos[:n, 0::2] = np.clip(pos[:n, 0::2] + rng.uniform(-30, 30, (n, 2)), 0, 6399.9)
        args = [torch.from_numpy(a.copy()) for a in (pos, valid, ids)]
        K.reset_launch_counts()
        got = card(*(a.to(cards[0]) for a in args))
        for k, v in K.launch_counts().items():
            launches[k] += v
        want = cpu(*args)
        names = ("owned_ids", "owned_cells", "owned_xyz", "counts", "halo_lo", "halo_hi",
                 "undelivered", "overflow")
        bad = [name for name, a, b in zip(names, got, want) if not torch.equal(a.cpu(), b)]
        for name in bad:
            print(f"MISMATCH 7a halo plane tick {t}: {name} differs between cuda and cpu")
        check(not bad, f"7a halo plane tick {t}: cuda and cpu differ in {bad}")
        counts = got[3].cpu()
        dense = ops.cell_counts(ops.assign_cells(grid, args[0], args[1]), grid.num_cells)
        check(torch.equal(counts.reshape(-1), dense), f"7a halo plane tick {t}: counts differ "
              f"from the dense histogram")
        check(int(got[7].sum()) == 0, f"7a halo plane tick {t}: a bucket overflowed")
        cols = grid.cols
        for s in range(MESH_SHARDS):
            lo = counts[s - 1][-cols:] if s > 0 else torch.zeros(cols, dtype=torch.int32)
            hi = counts[s + 1][:cols] if s < MESH_SHARDS - 1 else torch.zeros(cols, dtype=torch.int32)
            check(torch.equal(got[4][s].cpu(), lo) and torch.equal(got[5][s].cpu(), hi),
                  f"7a halo plane tick {t}: shard {s}'s halos are not its neighbours' rows")
        owned = got[0].cpu().reshape(-1)
        check(sorted(owned[owned >= 0].tolist()) == ids[:n].tolist(),
              f"7a halo plane tick {t}: entities lost or delivered twice")
    check(launches == {"assign_count": ticks * MESH_SHARDS, "aoi": 0},
          f"7a halo plane launched {launches}")
    print(f"7a halo plane: {ticks} ticks of {n} entities on the 64x64 grid over "
          f"{MESH_SHARDS} shards of 8 rows, bucket {bucket}: cuda equal to cpu on every output, "
          f"counts equal to the dense histogram, halos equal to the neighbours' rows, every "
          f"entity delivered once; K1 {launches['assign_count']} launches")


class MeshEngineLoad:
    """Phase 7b's seeded traffic through the engine API at the sidecar's
    width: 100,000 entities on BENCH_GRID of which a fifth move each tick
    (50 leave and 50 join), 4,096 standing queries (sphere, box, cone,
    and spots on every ninth), 16,384 subscriptions at 33-200 ms with
    churn; tick ``storm`` gathers entities // 50 (2,000) into cell 7
    (past the cells plane's bucket for block 0, under every row budget),
    and they disperse two ticks later."""

    WORLD = 30000.0

    def __init__(self, rng: np.random.Generator, n: int, queries: int, subs: int, storm: int):
        self.rng, self.storm = rng, storm
        self.crowd_size = n // 50
        self.lo = BENCH_GRID["offset_x"]
        self.ids = list(range(0x80001, 0x80001 + n))
        self.next_id = self.ids[-1] + 1
        self.pos = {e: (float(x), 0.0, float(z)) for e, (x, z) in
                    zip(self.ids, rng.uniform(self.lo, self.lo + self.WORLD, (n, 2)))}
        self.n_queries, self.n_subs = queries, subs
        self.subs: list[int] = []

    def point(self):
        x, z = self.rng.uniform(self.lo, self.lo + self.WORLD, 2)
        return float(np.float32(x)), 0.0, float(np.float32(z))

    def query(self, conn: int):
        r = self.rng
        if conn % 9 == 0:
            spots = [tuple(float(v) for v in r.uniform(self.lo, self.lo + self.WORLD, 2))
                     for _ in range(int(r.integers(1, 6)))]
            return ("set_spots_query", conn, spots,
                    [int(d) for d in r.integers(0, 5, int(r.integers(0, len(spots) + 1)))] or None)
        d = r.normal(size=2)
        return ("set_query", conn, int(r.integers(1, 4)), self.point()[::2],
                tuple(float(v) for v in r.uniform(100, 8000, 2)), (float(d[0]), float(d[1])),
                float(r.uniform(0.05, 1.5)))

    def setup(self) -> list:
        ops = [("add_entity", e, *p) for e, p in self.pos.items()]
        ops += [self.query(c) for c in range(1, self.n_queries + 1)]
        ops += [("add_subscription", int(self.rng.integers(33, 201)),
                 int(self.rng.integers(0, 200))) for _ in range(self.n_subs)]
        return ops

    def step(self, t: int) -> list:
        r, ops = self.rng, []
        for i in r.choice(len(self.ids), len(self.ids) // 5, replace=False):
            e = self.ids[i]
            x, _, z = self.pos[e]
            x = float(np.float32((x + r.uniform(-60, 60) - self.lo) % self.WORLD + self.lo))
            z = float(np.float32((z + r.uniform(-60, 60) - self.lo) % self.WORLD + self.lo))
            self.pos[e] = (x, 0.0, z)
            ops.append(("update_entity", e, x, 0.0, z))
        if t == self.storm:
            cx, cz = self.lo + 7.5 * 2000.0, self.lo + 0.5 * 2000.0  # cell 7: block 0
            self.crowd = [self.ids[i] for i in r.choice(len(self.ids), self.crowd_size,
                                                        replace=False)]
            for e in self.crowd:
                self.pos[e] = (float(np.float32(cx + r.uniform(-800, 800))), 0.0,
                               float(np.float32(cz + r.uniform(-800, 800))))
                ops.append(("update_entity", e, *self.pos[e]))
        if t == self.storm + 2:
            for e in self.crowd:
                if e in self.pos:
                    self.pos[e] = self.point()
                    ops.append(("update_entity", e, *self.pos[e]))
        if t > 0:
            for i in sorted(r.choice(len(self.ids), 50, replace=False), reverse=True):
                e = self.ids.pop(int(i))
                del self.pos[e]
                ops.append(("remove_entity", e))
            for _ in range(50):
                e, self.next_id = self.next_id, self.next_id + 1
                self.ids.append(e)
                self.pos[e] = self.point()
                ops.append(("add_entity", e, *self.pos[e]))
            for c in r.choice(self.n_queries, 16, replace=False):
                ops.append(self.query(int(c) + 1))
            for s in r.choice(len(self.subs), 50, replace=False) if self.subs else ():
                ops.append(("reset_sub_clock", self.subs[int(s)], 1000 + 33 * t))
        return ops


def storm_bucket(ops, grid, pos: np.ndarray, valid: np.ndarray, crowd: int) -> int:
    """A cells-plane bucket that a quiet tick fills to within half of a
    storm's share and a storm of ``crowd`` entities into block 0 (drawn
    from every shard that holds entities) overflows: the largest (source
    shard, block 0) load of the slot arrays ``pos``/``valid`` plus half
    of each source's share of the crowd."""
    from channeld_tpu_torch.parallel.spatial_alltoall import cells_per_shard

    cells = ops.assign_cells(grid, torch.from_numpy(pos), torch.from_numpy(valid)).numpy()
    live = cells >= 0
    source = np.arange(pos.shape[0])[live] // (pos.shape[0] // MESH_SHARDS)
    load = np.bincount(source[cells[live] < cells_per_shard(grid, MESH_SHARDS)],
                       minlength=MESH_SHARDS)
    return int(load.max()) + crowd // len(np.unique(source)) // 2


def apply_ops(engines, ops, load: MeshEngineLoad) -> None:
    for op in ops:
        slots = {getattr(eng, op[0])(*op[1:]) for eng in engines}
        if op[0] == "add_subscription":
            check(len(slots) == 1, "the engines gave one subscription different slots")
            load.subs.append(slots.pop())


def engine_tick_obs(eng, now: int, reads=None) -> dict:
    """One engine tick and everything the host reads of it."""
    t0 = time.perf_counter()
    with reads if reads is not None else contextlib.nullcontext():
        result = eng.tick(now)
        count, rows, counts, due = eng.consume(result)
        q = eng.query_changed_rows(result)
        undelivered = eng.undelivered_slots(result)
    ms = (time.perf_counter() - t0) * 1e3
    return dict(handovers=eng.handover_list(result), count=count, counts=counts.copy(),
                due=np.nonzero(due)[0].tolist(), q=(q[0], q[1][: min(q[0], len(q[1]))].tolist()),
                undelivered=undelivered, overflow=eng.last_overflow, ms=ms)


class EngineTicker:
    def __init__(self, eng):
        self.eng = eng

    def tick(self, t: int) -> None:
        self.eng.tick(1000 + 33 * t)
        self.eng.consume(self.eng.last_result)


def phase_mesh_engine(K, engine_mod, ops) -> dict:
    """7b: SpatialEngine(mesh=...) in both shardings at the sidecar's
    width with the standing-query plane on, 30 ticks, on the card against
    the meshed engine on the CPU (exactly) and against the unmeshed
    engine on the card (counts only on ticks without overflow); reads
    and host waits per steady tick; rebuild, corrupt + rebuild and
    apply_grid, each verified clean. Returns launches on this path."""
    from channeld_tpu_torch.parallel import mesh as PM

    grid = ops.GridSpec(**BENCH_GRID)
    swap = ops.GridSpec(-15000.0, -15000.0, 1000.0, 1000.0, 30, 30)
    cards = mesh_cards()
    dev = cards[0]
    ticks, storm = MESH_SIZE["ticks"], MESH_SIZE["storm"]
    launches = {"assign_count": 0, "aoi": 0}
    caps = dict(entity_capacity=MESH_SIZE["slots"], query_capacity=MESH_SIZE["queries"],
                sub_capacity=MESH_SIZE["subs"], max_handovers=MESH_SIZE["rows"],
                query_rows_max=QUERY_ROWS_MAX)
    t_phase = time.perf_counter()
    for sharding in ("entities", "cells"):
        load = MeshEngineLoad(np.random.default_rng(SEED + 9), MESH_SIZE["entities"],
                              MESH_SIZE["queries"], MESH_SIZE["subs"] // 4, storm)
        setup = load.setup()
        bucket = 0
        if sharding == "cells":
            # Entities take slots in the order they are added.
            cap = caps["entity_capacity"]
            pos = np.zeros((cap, 3), np.float32)
            pos[:len(load.ids)] = [load.pos[e] for e in load.ids]
            bucket = storm_bucket(ops, grid, pos, np.arange(cap) < len(load.ids),
                                  load.crowd_size)
        card = engine_mod.SpatialEngine(grid, mesh=PM.make_mesh(cards), sharding=sharding,
                                        cell_bucket=bucket, device="cuda", **caps)
        cpu = engine_mod.SpatialEngine(grid, mesh=PM.make_mesh(["cpu"] * MESH_SHARDS),
                                       sharding=sharding, cell_bucket=bucket, device="cpu", **caps)
        single = engine_mod.SpatialEngine(grid, device=dev, **caps)
        engines = (card, cpu, single)
        for eng in engines:
            eng.warmup()  # on the empty tables: builds the kernels, changes nothing
            eng.track_query_changes = True
        apply_ops(engines, setup, load)
        card_ms, single_ms, reads, syncs, overflow_ticks = [], [], [], [], []
        single_reads, single_syncs = [], []
        mismatches: list[str] = []
        want = {"assign_count": MESH_SHARDS, "aoi": MESH_SHARDS if sharding == "cells" else 1}
        for t in range(ticks):
            apply_ops(engines, load.step(t), load)
            now = 1000 + 33 * t
            sync_cards()
            K.reset_launch_counts()
            r = Reads()
            a = engine_tick_obs(card, now, r)
            got = K.launch_counts()
            if got != want:
                mismatches.append(f"{sharding} tick {t}: launches {got}, not {want}")
            for k in launches:
                launches[k] += got[k]
            reads.append(r.count)
            syncs.append(r.syncs)
            card_ms.append(a["ms"])
            b = engine_tick_obs(cpu, now)
            sync_cards()
            rs = Reads()
            s = engine_tick_obs(single, now, rs)
            single_reads.append(rs.count)
            single_syncs.append(rs.syncs)
            single_ms.append(s["ms"])
            for key in ("handovers", "count", "due", "q", "undelivered", "overflow"):
                if a[key] != b[key]:
                    mismatches.append(f"{sharding} tick {t}: {key} differs between cuda and cpu")
            if not np.array_equal(a["counts"], b["counts"]):
                mismatches.append(f"{sharding} tick {t}: counts differ between cuda and cpu")
            for key in ("handovers", "due", "q"):
                if a[key] != s[key]:
                    mismatches.append(f"{sharding} tick {t}: {key} differs from the unmeshed "
                                      f"engine")
            if a["overflow"]:
                overflow_ticks.append(t)
            elif not np.array_equal(a["counts"], s["counts"]):
                mismatches.append(f"{sharding} tick {t}: counts differ from the unmeshed engine")
        for line in mismatches[:60]:
            print(f"MISMATCH 7b {line}")
        check(not mismatches, f"7b {sharding}: {len(mismatches)} mismatches (printed above)")
        steady = [t for t in range(1, ticks) if t not in (storm, storm + 2)]
        check(sorted({reads[t] for t in steady}) == [2],
              f"7b {sharding}: device reads per steady tick {sorted(set(reads))}, not 2")
        if sharding == "cells":
            check(storm in overflow_ticks, f"7b cells: the storm did not overflow the bucket "
                  f"(overflow ticks {overflow_ticks})")
        prof = profile_ticks(EngineTicker(card), ticks)
        recover = {}
        for name, fn in (("rebuild", lambda e: e.rebuild_device_state(cell_seeds(e, grid), 9000)),
                         ("corrupt_rebuild", lambda e: (e.corrupt_device_state_for_chaos(),
                                                        e.rebuild_device_state(cell_seeds(e, grid),
                                                                               9000))),
                         ("apply_grid", lambda e: e.apply_grid(swap, cell_seeds(e, swap), 9000))):
            for eng in (card, cpu):
                t0 = time.perf_counter()
                fn(eng)
                errors = eng.verify_device_state(cell_seeds(eng, eng.grid))
                if eng is card:
                    sync_cards()
                    recover[name] = (time.perf_counter() - t0) * 1e3
                check(not errors, f"7b {sharding} {name} on {eng.device}: verify found {errors}")
        a, b = engine_tick_obs(card, 10_000), engine_tick_obs(cpu, 10_000)
        check(all(a[k] == b[k] for k in ("handovers", "count", "due", "q", "undelivered"))
              and np.array_equal(a["counts"], b["counts"]),
              f"7b {sharding}: cuda and cpu differ on the tick after apply_grid")

        print(f"7b engine {sharding} on {MESH_SHARDS} shards (cell_bucket {bucket or 'exact'}): {ticks} "
              f"ticks at 1<<17 slots, {len(load.ids)} entities (a fifth moving), 4,096 queries, "
              f"16,384 subscriptions, the standing-query plane on: cuda equal to the CPU mesh on "
              f"every read, and to the unmeshed engine on handovers, due ids and changed rows "
              f"(counts on the ticks without overflow; overflow ticks {overflow_ticks}); "
              f"launches per tick {want}; reads per steady tick {sorted({reads[t] for t in steady})} "
              f"(unmeshed {sorted({single_reads[t] for t in steady})}), host waits "
              f"{sorted({syncs[t] for t in steady})} (unmeshed "
              f"{sorted({single_syncs[t] for t in steady})}); tick+reads host {tick_stats(card_ms[1:])} "
              f"(unmeshed {tick_stats(single_ms[1:])}); rebuild + verify "
              f"{recover['rebuild']:.2f} ms, corrupt + rebuild + verify "
              f"{recover['corrupt_rebuild']:.2f} ms, apply_grid + verify "
              f"{recover['apply_grid']:.2f} ms, each clean, and the next tick equal on both")
        if prof["busy_ms"] is None:
            print(f"7b {sharding} profile: the trace recorded no device time (not measured)")
        else:
            print(f"7b {sharding} profile (5 ticks): tick wall {prof['wall_ms']:.2f} ms, device "
                  f"busy {prof['busy_ms']:.3f} ms, idle share {prof['idle']:.4f}; top: "
                  + "; ".join(f"{k[:40]} {ms:.3f} ms x{c:g}" for k, ms, c in prof["top"]))
        del card, cpu, single
    print(f"7b: {time.perf_counter() - t_phase:.1f} s; {mesh_note()}")
    return launches


def phase_mesh_gateway(K, size: dict = MESH_GATEWAY) -> dict:
    """7c: phase 6a's world through the port's controller on a mesh
    (Sharding "cells", MeshDevices = min(cards, 8), a CellBucket below
    the entities per shard), card leg against CPU leg at the same mesh,
    tick for tick. Returns launches on this path."""
    import json
    import shutil
    import tempfile

    n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
    with open(GATEWAY_CONFIG) as f:
        cfg = json.load(f)
    # Every entity lives in shard 0's slots (slots are handed out from 0),
    # so each (source 0, destination) bucket carries its block's share;
    # a bucket of 15/16 of an even share overflows (on a mesh of one,
    # every tick, by about entities // 16).
    bucket = max(1, (size["entities"] * 15) // (16 * n_dev))
    cfg["Config"].update(MeshDevices=n_dev, Sharding="cells", CellBucket=bucket)
    scratch = tempfile.mkdtemp(prefix="mesh-gateway-")
    path = f"{scratch}/spatial_tpu_cells_mesh.json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    gsize = dict(gateway_size(size["entities"], size["ticks"]), config=path)
    ticks = gsize["ticks"]
    t_phase = time.perf_counter()
    try:
        with FixedClock() as clock:
            world = GatewayWorld(torch.device("cuda", 0), clock, gsize)
            check(world.eng._mesh is not None and world.eng._mesh.size == n_dev,
                  "the gateway's engine is not meshed")
            K.reset_launch_counts()
            card = [world.tick(t) for t in range(ticks)]
            launches = K.launch_counts()
            world.close()
            del world
        with FixedClock() as clock:
            world = GatewayWorld(torch.device("cpu"), clock, gsize)
            cpu = []
            for t in range(ticks):
                cpu.append(world.tick(t))
                where = first_gateway_diff(card[t], cpu[t])
                if where is not None:
                    print(f"MISMATCH 7c gateway tick {t}: {where}")
                check(where is None, f"7c gateway tick {t}: cuda and cpu differ: {where}")
            world.close()
            del world
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    want = {"assign_count": ticks * n_dev, "aoi": ticks * n_dev}
    check(launches == want, f"7c: launches {launches}, not {want}")
    overflow = [o["overflow"] for o in card]
    check(sum(overflow) > 0, "7c: the bucket never overflowed")
    reads = sorted({o["reads"] for o in card[1:]})
    check(reads == [2], f"7c: device reads per steady gateway tick {reads}, not 2")
    handovers = sum(len(o["handovers"]) for o in card)
    check(handovers > 0, "7c: no handover in the run")

    print(f"7c gateway on a mesh of {n_dev} (Sharding cells, CellBucket {bucket}): {ticks} "
          f"GLOBAL ticks of {size['entities']} moving entity channels on {GATEWAY_CONFIG} "
          f"(storms at {gsize['storms']}; no sim plane on a mesh) on cuda equal the CPU leg "
          f"tick for tick: handovers ({handovers}), entity tables, every outbound stream, "
          f"changed query rows, undelivered slots and the tpu_cell_overflow_total delta "
          f"(per tick {overflow}); launches {launches}; reads per steady tick {reads}, host "
          f"waits {sorted({o['syncs'] for o in card[1:]})}; tick {tick_stats([o['tick_ms'] for o in card[1:]])}, "
          f"GLOBAL tick {tick_stats([o['global_ms'] for o in card[1:]])}, guarded device step "
          f"{tick_stats([o['step_ms'] for o in card[1:]])}; phase {time.perf_counter() - t_phase:.1f} s; "
          f"{mesh_note() if n_dev > 1 else '1 card: a mesh of one (the mesh path, bucket and shed)'}")
    return launches

# ---- phase 8: the engines' paths through the gateway ------------------------

# 8a: an engine's dedicated servers on config4's world, cut by the
# phase's time as 6a is (~0.08-0.16 ms per moving entity channel and
# tick on the card's host): 5,000 objects x 12 ticks (10,000 before
# phase 12 joined). 8b: the Unreal
# types, 1,000 objects x 6 ticks. ``--engine-adapter OBJECTS TICKS``
# runs 8a alone at another size.
ENGINE_OBJECTS, ENGINE_TICKS = 5_000, 12
UNREAL_OBJECTS, UNREAL_TICKS = 1_000, 6


def engine_size(objects: int = ENGINE_OBJECTS, ticks: int = ENGINE_TICKS) -> dict:
    storm = ticks // 4
    destroy_at = ticks // 2 if ticks // 2 not in (storm, storm + 2) else ticks // 2 + 1
    return dict(entities=objects, followers=256, sensors=0, subscribers=256, ticks=ticks,
                census_every=max(1, ticks // 3), storms=(storm,), sim=False,
                destroy_at=destroy_at)


class EngineAdapterWorld(GatewayWorld):
    """6a's world with the objects coming and going through the port's
    engine adapter (models/engine_adapter.py), as an engine's dedicated
    servers drive it: the master creates each object's entity channel in
    GLOBAL (ownership passes to the cell's server, which the adapter
    enters in the cell's entity table) and spawns it by SPAWN (103) with
    its location, which the adapter routes to the cell's spatial
    channel. Every 16th object is non-spatial (a game-mode actor),
    spawned on GLOBAL without a location: the adapter's recovery table
    holds it. Objects move +-60 m per tick by entity channel updates; a
    storm gathers an eighth into one cell and scatters them two ticks
    later; at ``destroy_at`` a tenth are destroyed by DESTROY (104) on
    their spatial channels (and one game-mode actor on GLOBAL), and
    spawned again the tick after. No sim plane, no sensors."""

    ADAPTER = "models.engine_adapter"

    def _register_types(self) -> None:
        import importlib

        super()._register_types()
        self.adapter = importlib.import_module(f"channeld_tpu_torch.{self.ADAPTER}")

    def _install_adapter(self) -> None:
        self.adapter.init_message_handlers()

    def _global_data(self):
        return None  # the registered GLOBAL type (models/sim.py's)

    def _entities(self, rng) -> None:
        import importlib

        P, ctl = self.P, self.ctl
        self.mods = NS(**{k: importlib.import_module(f"channeld_tpu_torch.{v}") for k, v in dict(
            messages="spatial.messages", anyutil="utils.anyutil", spatial_pb2="protocol.spatial_pb2",
            wire_pb2="protocol.wire_pb2").items()})
        self._install_adapter()
        self.gch = P.channel.get_global_channel()
        self.gch.init_data(self._global_data(), None)  # with the adapter's recovery extension
        self.master = self.conns[0]
        x0, z0 = ctl.world_offset_x + 1.0, ctl.world_offset_z + 1.0
        x1 = ctl.world_offset_x + ctl.grid_width * ctl.grid_cols - 1.0
        z1 = ctl.world_offset_z + ctl.grid_height * ctl.grid_rows - 1.0
        self.bounds = (x0, z0, x1, z1)
        estart = P.settings.global_settings.entity_channel_id_start
        self.positions: dict[int, tuple[float, float]] = {}
        self.props: list[int] = []
        for i in range(self.size["entities"]):
            eid = estart + 1 + i
            if i % 16 == 15:
                self.spawn_prop(eid)
            else:
                self.spawn(eid, rng.uniform(x0, x1), rng.uniform(z0, z1), queued=False)
        self.entity_ids = list(self.positions)
        self._refresh_channels()
        self.crowd: list[int] = []
        self.gone: list[int] = []

    def _refresh_channels(self) -> None:
        chans = self.P.channel.all_channels()
        self.entity_channels = [chans[e] for e in self.entity_ids if e in chans]

    def _dispatch(self, msg_type: int, channel, msg, handler, queued: bool,
                  connection=None) -> None:
        """One message from a server, as the gateway dispatches it: queued
        on its channel (handled in that channel's next tick), or handled
        at once during setup."""
        ctx = self.P.message.MessageContext(
            msg_type=msg_type, msg=msg, channel=channel, channel_id=channel.id,
            connection=connection or (self.master if channel is self.gch else channel.get_owner()))
        if queued:
            channel.put_message_context(ctx, handler)
        else:
            handler(ctx)

    def _forward(self, msg_type: int, channel, payload: bytes, queued: bool = True) -> None:
        msg = self.mods.wire_pb2.ServerForwardMessage(payload=payload)
        self._dispatch(msg_type, channel, msg, self.P.message.MESSAGE_MAP[msg_type].handler, queued)

    def spawn(self, eid: int, x: float, z: float, queued: bool = True) -> None:
        P, m = self.P, self.mods
        d = P.sim_pb2.SimEntityChannelData()
        d.state.entityId = eid
        d.state.transform.position.x = x
        d.state.transform.position.z = z
        create = m.spatial_pb2.CreateEntityChannelMessage(entityId=eid, data=m.anyutil.pack_any(d))
        self._dispatch(P.types.MessageType.CREATE_ENTITY_CHANNEL, self.gch, create,
                       m.messages.handle_create_entity_channel, queued)
        spawn = P.sim_pb2.SpawnObjectMessage(channelId=0)
        spawn.obj.netId = eid
        spawn.location.x, spawn.location.z = x, z
        self._forward(self.adapter.MSG_SPAWN, self.gch, spawn.SerializeToString(), queued)
        self.positions[eid] = (x, z)

    def spawn_prop(self, eid: int) -> None:
        spawn = self.P.sim_pb2.SpawnObjectMessage(channelId=0)
        spawn.obj.netId = eid
        spawn.obj.owningConnId = self.master.id
        self._forward(self.adapter.MSG_SPAWN, self.gch, spawn.SerializeToString(), queued=False)
        self.props.append(eid)

    def destroy(self, eid: int, channel) -> None:
        msg = self.P.sim_pb2.DestroyObjectMessage(netId=eid)
        self._forward(self.adapter.MSG_DESTROY, channel, msg.SerializeToString())

    def spatial_channel_of(self, eid: int):
        """The spatial channel whose entity table holds ``eid`` (None while
        a handover has it in neither)."""
        chans = self.P.channel.all_channels()
        for cid in self.spatial:
            if eid in chans[cid].get_data_message().entities:
                return chans[cid]
        return None

    def drive(self, t: int) -> None:
        """Every object moves each tick; a storm tick gathers an eighth in
        one cell, scattered two ticks later; ``destroy_at`` queues the
        destroys, and the tick after spawns those objects again."""
        x0, z0, x1, z1 = self.bounds
        rng, ctl = self.rng, self.ctl
        crowd: set = set()
        if t in self.size["storms"]:
            col, row = rng.randrange(ctl.grid_cols), rng.randrange(ctl.grid_rows)
            cx = ctl.world_offset_x + (col + 0.5) * ctl.grid_width
            cz = ctl.world_offset_z + (row + 0.5) * ctl.grid_height
            self.crowd = rng.sample(self.entity_ids, len(self.entity_ids) // 8)
            crowd = set(self.crowd)
            for eid in self.crowd:
                self.move(eid, cx + rng.uniform(-0.4, 0.4) * ctl.grid_width,
                          cz + rng.uniform(-0.4, 0.4) * ctl.grid_height)
        elif any(t - 2 == s for s in self.size["storms"]):
            crowd = set(self.crowd) & set(self.entity_ids)
            for eid in sorted(crowd, key=self.crowd.index):
                self.move(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
        if t == self.size["destroy_at"]:
            self.gone = []
            for eid in rng.sample(self.entity_ids, len(self.entity_ids) // 10):
                channel = self.spatial_channel_of(eid)
                if channel is not None:
                    self.destroy(eid, channel)
                    del self.positions[eid]
                    self.gone.append(eid)
            self.destroy(self.props[0], self.gch)
            gone = set(self.gone)
            self.entity_ids = [e for e in self.entity_ids if e not in gone]
            crowd |= gone
        elif t == self.size["destroy_at"] + 1:
            for eid in self.gone:
                self.spawn(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
            crowd |= set(self.gone)
        for eid in self.entity_ids:
            if eid in crowd:
                continue
            x, z = self.positions[eid]
            self.move(eid, min(max(x + rng.uniform(-60, 60), x0), x1),
                      min(max(z + rng.uniform(-60, 60), z0), z1))

    def tick(self, t: int) -> dict:
        obs = super().tick(t)
        if t == self.size["destroy_at"] + 1:
            self.entity_ids += self.gone  # their channels exist after this tick's GLOBAL
        self._refresh_channels()
        obs["recovery"] = self.recovery_digest()
        return obs

    def recovery_digest(self) -> tuple:
        spawned = self.gch.data.extension.spawned_objs
        h = hashlib.sha256()
        for net_id in sorted(spawned):
            h.update(spawned[net_id].SerializeToString(deterministic=True))
        return len(spawned), h.hexdigest()


class UnrealWorld(EngineAdapterWorld):
    """8a's traffic in the Unreal SDK's types through the port's
    compat/unreal.py: SPATIAL channels hold unrealpb.SpatialChannelData,
    each object's entity channel an unrealpb.SpatialEntityState (its
    objRef), spawns carry unrealpb.FVector locations (UE Z-up: the
    ground plane is x, y), which to_spatial_info swaps to the gateway's
    Y-up. A server creates the entity channel in its first cell and
    spawns it there; the SPAWN handler routes it to its location's cell.
    A move is the engine's replicated location run through the engine
    adapter's check_entity_handover (Z-up swap) into the controller's
    notify, on the entity channel's tick; the game-mode actors sit in
    the UnrealRecoverableExtension of GLOBAL."""

    ADAPTER = "compat.unreal"

    def _register_types(self) -> None:
        import importlib

        self.adapter = importlib.import_module("channeld_tpu_torch.compat.unreal")
        self.handover = importlib.import_module(
            "channeld_tpu_torch.models.engine_adapter").check_entity_handover
        self.adapter.register_unreal_types()  # as -imports runs its hook

    def _global_data(self):
        return self.adapter.unrealpb.SpatialChannelData()  # any data message

    def _install_adapter(self) -> None:
        self.home = {}
        for cid in self.spatial:
            owner = self.P.channel.get_channel(cid).get_owner()
            self.home.setdefault(owner.id, cid)
        self.locations: dict = {}

    def spawn(self, eid: int, x: float, z: float, queued: bool = True) -> None:
        P, m, pb = self.P, self.mods, self.adapter.unrealpb
        ue = pb.FVector(x=x, y=z, z=90.0)  # UE: y is the ground plane's second axis
        info = self.adapter.to_spatial_info(ue)
        owner = P.channel.get_channel(self.ctl.get_channel_id(info)).get_owner()
        home = P.channel.get_channel(self.home[owner.id])
        state = pb.SpatialEntityState()
        state.objRef.netGUID = eid
        create = m.spatial_pb2.CreateEntityChannelMessage(entityId=eid,
                                                          data=m.anyutil.pack_any(state))
        self._dispatch(P.types.MessageType.CREATE_ENTITY_CHANNEL, home, create,
                       m.messages.handle_create_entity_channel, queued, connection=owner)
        spawn = pb.SpawnObjectMessage(channelId=home.id)
        spawn.obj.netGUID = eid
        spawn.location.CopyFrom(ue)
        self._forward(self.adapter.MSG_SPAWN, home, spawn.SerializeToString(), queued)
        # The engine's first replicated location: the controller learns it.
        observe = lambda: self.ctl.observe_entity(eid, info, lambda s, d, e=eid: e)  # noqa: E731
        if queued:
            home.execute(lambda _c: observe())
        else:
            observe()
        self.locations[eid] = ue
        self.positions[eid] = (x, z)

    def spawn_prop(self, eid: int) -> None:
        spawn = self.adapter.unrealpb.SpawnObjectMessage(channelId=0)
        spawn.obj.netGUID = eid
        self._forward(self.adapter.MSG_SPAWN, self.gch, spawn.SerializeToString(), queued=False)
        self.props.append(eid)

    def destroy(self, eid: int, channel) -> None:
        msg = self.adapter.unrealpb.DestroyObjectMessage(netId=eid, reason=0)
        self._forward(self.adapter.MSG_DESTROY, channel, msg.SerializeToString())

    def move(self, eid: int, x: float, z: float) -> None:
        old = self.locations[eid]
        new = self.adapter.unrealpb.FVector(x=x, y=z, z=old.z)
        ctl = self.ctl

        def replicate(_c):
            moved, old_info, new_info = self.handover(eid, new, old, swap_yz=True)
            if moved:
                ctl.notify(old_info, new_info, lambda s, d: eid)

        self.P.channel.get_channel(eid).execute(replicate)
        self.locations[eid] = new
        self.positions[eid] = (x, z)

    def recovery_digest(self) -> tuple:
        refs = self.gch.data.extension.obj_refs
        h = hashlib.sha256()
        for net_id in sorted(refs):
            h.update(refs[net_id].SerializeToString(deterministic=True))
        return len(refs), h.hexdigest()


def run_engine_world(world_cls, K, size: dict, label: str, profile: bool,
                     dev=torch.device("cuda", 0)) -> dict:
    """A phase-8 world on the card (``dev``), then on the CPU, tick for
    tick; K1 and K2 launched on every card tick. Returns the card leg's
    observations, its launches per tick, profile and wall times."""
    ticks = size["ticks"]
    t_phase = time.perf_counter()
    with FixedClock() as clock:
        world = world_cls(dev, clock, size)
        setup_s = world.load_s
        K.reset_launch_counts()
        card, per_tick = [], []
        for t in range(ticks):
            before = K.launch_counts()
            card.append(world.tick(t))
            per_tick.append({k: v - before[k] for k, v in K.launch_counts().items()})
        launches = K.launch_counts()
        bad = [(t, n) for t, n in enumerate(per_tick) if min(n.values()) < 1]
        check(not bad, f"{label}: ticks without a K1 or K2 launch: {bad}")
        gateway_live_kernels(K, world.eng)
        prof = profile_gateway(world, ticks) if profile else None
        world.close()
        del world
    t_card = time.perf_counter()
    with FixedClock() as clock:
        world = world_cls(torch.device("cpu"), clock, size)
        for t in range(ticks):
            where = first_gateway_diff(card[t], world.tick(t))
            if where is not None:
                print(f"MISMATCH {label} tick {t}: {where}")
            check(where is None, f"{label} tick {t}: cuda and cpu differ: {where}")
        world.close()
        del world
    return dict(card=card, launches=launches, per_tick=per_tick, prof=prof,
                secs=(time.perf_counter() - t_phase, t_card - t_phase), setup_s=setup_s)


def phase_engine_adapter(K, size: dict, dev=torch.device("cuda", 0)) -> dict:
    """8a: the engine-adapter world on GATEWAY_CONFIG, card leg against
    CPU leg. Returns K1/K2 launches on this path."""
    run = run_engine_world(EngineAdapterWorld, K, size, "8a engine adapter", True, dev)
    card, ticks = run["card"], size["ticks"]
    handovers = sum(len(o["handovers"]) for o in card)
    check(handovers > 0, "8a: no handover in the run")
    reads = sorted({o["reads"] for o in card[1:]})
    check(reads == [2], f"8a: device reads per steady tick {reads}, not 2")
    recovery = [o["recovery"][0] for o in card]
    props = size["entities"] // 16
    check(recovery[0] == props and recovery[-1] == props - 1,
          f"8a: recovery table sizes {recovery}, not {props} then {props - 1}")
    print(f"8a engine adapter: {ticks} GLOBAL ticks of {size['entities']} objects "
          f"({props} of them non-spatial) spawned by SPAWN (103) through "
          f"channeld_tpu_torch.models.engine_adapter on {GATEWAY_CONFIG} (storm of an eighth "
          f"at {size['storms']}, DESTROY (104) of a tenth at tick {size['destroy_at']} and "
          f"their respawn, {size['followers']} followers, {size['subscribers']} subscribers) "
          f"on cuda equal the CPU leg tick for tick: handovers ({handovers}), spatial entity "
          f"tables, the adapter's recovery table ({recovery[0]} -> {recovery[-1]}), every "
          f"outbound stream, changed query rows; launches {run['launches']} (per tick "
          f"{sorted({tuple(n.values()) for n in run['per_tick']})}); phase "
          f"{run['secs'][0]:.1f} s (card leg {run['secs'][1]:.1f} s, load_config "
          f"{run['setup_s']:.2f} s)")
    print(f"8a per tick on cuda (ticks 1-{ticks - 1}): tick "
          f"{tick_stats([o['tick_ms'] for o in card[1:]])}; GLOBAL tick "
          f"{tick_stats([o['global_ms'] for o in card[1:]])}; guarded device step "
          f"{tick_stats([o['step_ms'] for o in card[1:]])}; reads per steady tick {reads}, "
          f"host waits {sorted({o['syncs'] for o in card[1:]})}")
    prof = run["prof"]
    if prof["busy_ms"] is None:
        print("8a profile: the trace recorded no device time (idle share not measured)")
    else:
        check(prof["k1"] == 1 and prof["k2"] == 1,
              f"8a profiled ticks ran K1 {prof['k1']} and K2 {prof['k2']} times per tick")
        print(f"8a profile (5 ticks): tick wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, idle share {prof['idle']:.4f}; top: " + "; ".join(
                  f"{k[:48]} {ms:.3f} ms x{c:g}" for k, ms, c in prof["top"]))
    return run["launches"]


def phase_unreal(K, objects: int = UNREAL_OBJECTS, ticks: int = UNREAL_TICKS,
                 dev=torch.device("cuda", 0)) -> dict:
    """8b: 8a's traffic in the Unreal types (compat/unreal.py), card leg
    against CPU leg. Returns K1/K2 launches on this path."""
    size = engine_size(objects, ticks)
    run = run_engine_world(UnrealWorld, K, size, "8b unreal", False, dev)
    card = run["card"]
    handovers = sum(len(o["handovers"]) for o in card)
    check(handovers > 0, "8b: no handover in the run")
    recovery = [o["recovery"][0] for o in card]
    print(f"8b unreal: {ticks} GLOBAL ticks of {objects} UE objects spawned with "
          f"unrealpb.FVector locations through channeld_tpu_torch.compat.unreal (SPATIAL "
          f"data unrealpb.SpatialChannelData, moves through check_entity_handover's Z-up "
          f"swap) on cuda equal the CPU leg tick for tick: handovers ({handovers}), spatial "
          f"entity tables, the recovery objRefs ({recovery[0]} -> {recovery[-1]}), every "
          f"outbound stream; launches {run['launches']}; tick "
          f"{tick_stats([o['tick_ms'] for o in card[1:]])}, guarded device step "
          f"{tick_stats([o['step_ms'] for o in card[1:]])}; phase {run['secs'][0]:.1f} s")
    return run["launches"]


def phase_replay_live(dev_args=(), deadline_s: float = 180.0, connections: int = 8) -> None:
    """8c: ``python -m channeld_tpu_torch -imports channeld_tpu_torch.compat``
    as a child on the card; the master claims GLOBAL; ``python -m
    channeld_tpu_torch.replay run`` replays examples/sessions/chat_demo.cpr
    with ``connections`` connections against its CLIENT listener. The
    CLI exits 0 with every connection authenticated and every packet
    sent, the gateway's /metrics shows device_state 0, SIGTERM exits 0."""
    import os
    import shutil
    import signal
    import tempfile
    import urllib.request

    from channeld_tpu_torch.client import Client
    from channeld_tpu_torch.core.types import ChannelType, MessageType
    from channeld_tpu_torch.protocol import control_pb2

    sport, cport, mport = free_port(), free_port(), free_port()
    scratch = tempfile.mkdtemp(prefix="replay-")
    log_path = os.path.join(scratch, "gateway.log")
    log_fd = os.open(log_path, os.O_WRONLY | os.O_CREAT, 0o600)
    cmd = [sys.executable, "-m", "channeld_tpu_torch", "-dev", "-loglevel", "0",
           "-profilepath", scratch,
           "-sn", "tcp", "-sa", f"127.0.0.1:{sport}", "-cn", "tcp", "-ca", f"127.0.0.1:{cport}",
           "-mport", str(mport), "-cfsm", "config/client_authoritative_fsm.json",
           "-scc", GATEWAY_CONFIG, "-imports", "channeld_tpu_torch.compat", *dev_args]
    child = subprocess.Popen(cmd, stdout=log_fd, stderr=subprocess.STDOUT)
    os.close(log_fd)
    master = None

    def log() -> str:
        with open(log_path) as f:
            return f.read()

    def until(cond, what: str, timeout: float):
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            if master is not None:
                master.tick(timeout=0.01)
            if cond():
                return
            check(child.poll() is None, f"8c: gateway child exited ({child.returncode}) "
                                        f"while waiting for {what}: {log()[-2000:]}")
            time.sleep(0.02)
        raise PhaseFailed(f"8c: no {what} within {timeout} s; log: {log()[-2000:]}")

    try:
        until(lambda: "listening for SERVER" in log(), "server listener", deadline_s)
        master = Client(f"127.0.0.1:{sport}")
        master.auth(login_token="master", pit="master")
        master.flush()
        until(lambda: master.id != 0, "the master's auth", 20)
        created: list = []
        master.add_message_handler(MessageType.CREATE_CHANNEL,
                                   lambda _c, ch, m: created.append(ch))
        master.send(0, 0, MessageType.CREATE_CHANNEL,
                    control_pb2.CreateChannelMessage(channelType=ChannelType.GLOBAL))
        until(lambda: created, "GLOBAL's creation", 20)
        until(lambda: "listening for CLIENT" in log(), "client listener", 20)
        case = os.path.join(scratch, "case.json")
        with open(case, "w") as f:
            json.dump({"channeldAddr": f"127.0.0.1:{cport}", "connectionGroups": [{
                "cprFilePath": os.path.abspath("examples/sessions/chat_demo.cpr"),
                "connectionNumber": connections, "connectInterval": "20ms",
                "runningTime": "2s", "waitAuthSuccess": True, "authOnlyOnce": True}]}, f)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "channeld_tpu_torch.replay", "run", case],
                             capture_output=True, text=True, timeout=120)
        replay_s = time.perf_counter() - t0
        check(out.returncode == 0, f"8c: the replay CLI exited {out.returncode}: "
                                   f"{out.stderr[-2000:]}")
        result = json.loads(out.stdout.strip().splitlines()[-1])
        per_pass = 7  # chat_demo.cpr: AUTH, SUB_TO_CHANNEL and 5 CHANNEL_DATA_UPDATEs
        check(result["connections"] == connections and result["authenticated"] == connections,
              f"8c: {result['authenticated']} of {result['connections']} connections "
              f"authenticated, not all {connections}; the replay CLI's log: "
              f"{out.stderr[-1500:]}; the gateway's log: {log()[-3000:]}")
        check(result["packets_sent"] >= connections * per_pass,
              f"8c: {result['packets_sent']} packets sent, fewer than the session's "
              f"{per_pass} per connection")
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10) as r:
            metrics = r.read().decode()
        state = [ln for ln in metrics.splitlines() if ln.startswith("device_state")]
        check(state and float(state[0].split()[-1]) == 0.0,
              f"8c: /metrics device_state is {state}, not 0")
        child.send_signal(signal.SIGTERM)
        try:
            code = child.wait(timeout=20)
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"8c: the gateway child did not exit within 20 s of SIGTERM: "
                              f"{log()[-2000:]}")
        check(code == 0, f"8c: the gateway child exited {code} on SIGTERM: {log()[-2000:]}")
        text = log()
        check("spatial engine on cuda" in text or dev_args, "8c: the child's engine is not on cuda")
        check("tick task died" not in text, f"8c: a channel's tick task died in the gateway "
                                            f"child: {text[-3000:]}")
        print(f"8c replay: python -m channeld_tpu_torch.replay run replayed chat_demo.cpr "
              f"with {connections} connections against python -m channeld_tpu_torch "
              f"-imports channeld_tpu_torch.compat on {'cuda' if not dev_args else ' '.join(dev_args)}"
              f" in {replay_s:.1f} s: exit 0, {result}; /metrics {state[0]}; SIGTERM exit 0")
    finally:
        if master is not None:
            master.disconnect()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
        shutil.rmtree(scratch, ignore_errors=True)


def phase_native_codec() -> None:
    """Whether the port's native codec was built from its codec.cc and
    the port's framing takes it (else the pure-Python path, as the JAX
    package without its codec)."""
    from channeld_tpu_torch import native
    from channeld_tpu_torch.protocol import framing

    used = native.codec is not None and framing._native is native.codec
    print(f"native codec: {'built from channeld_tpu_torch/native/codec.cc and used by framing' if used else 'not built; framing takes the pure-Python path'}"
          + (f" ({native.codec.__file__})" if native.codec is not None else ""))


# ---- phase 10: the recovery path ------------------------------------------


def device_recovery_scenario(error_at: float, hang_at: float, nan_at: float,
                             stall_ms: float = 3500.0, seed: int = 20260804) -> dict:
    """The device-failure schedule of scripts/device_soak.py's
    ``build_scenario`` (the port's own copy): two transient step errors,
    retried with backoff and recovered without a rebuild; one step hang
    of ``stall_ms`` past the watchdog, whose first rebuild fails (FAILED,
    backoff, rebuild); one silent corruption for the readback sentinel.
    Times are seconds after arming."""
    return {"name": "device-recovery", "seed": seed, "faults": [
        {"point": "device.step_error", "every_n": 1, "start_at_s": error_at, "max_fires": 2},
        {"point": "device.step_hang", "every_n": 1, "start_at_s": hang_at, "max_fires": 1,
         "stall_ms": stall_ms},
        {"point": "device.rebuild_fail", "every_n": 1, "max_fires": 1},
        {"point": "device.nan", "every_n": 1, "start_at_s": nan_at, "max_fires": 1},
    ]}


def fault_ticks_scenario(error_tick: int, hang_tick: int, nan_tick: int,
                         stall_ms: float = 3500.0, tick_s: float = GATEWAY_TICK_S) -> dict:
    """``device_recovery_scenario`` on a fixed clock armed just before
    tick 0 and advanced ``tick_s`` per tick: each fault opens half a tick
    before its tick's time, so it fires on that tick on every leg."""
    return device_recovery_scenario(*((t + 0.5) * tick_s for t in (error_tick, hang_tick, nan_tick)),
                                    stall_ms=stall_ms)



# 10a: phase 6a's world (config4, the gateway's default capacities, the
# storms, followers, sensors, clients and the sim plane) on the device
# soak's schedule, card leg against CPU leg under one fixed clock. Cut to
# 3,000 entities (10,000 before phase 11 joined, 6,000 before phase 12) to
# fit the script's time;
# 30 ticks, as
# the schedule needs on a 33 ms clock: the transient errors' 100 + 200 ms
# backoffs hold ticks 4-6 and 8-13, the hang's failed rebuild its 200 ms
# backoff (17-22) and the rebuild (23), the corruption's rebuild 26.
# ``--recovery ENTITIES TICKS`` runs 10a alone at another size.
RECOVERY_ENTITIES, RECOVERY_TICKS = 3_000, 30
RECOVERY_FAULT_TICKS = (3, 16, 26)  # transient errors, hang, corruption: each on a storm tick
RECOVERY_DEADLINE_S = 2.0  # device_step_deadline_s on both legs, the gateway's default
RECOVERIES = {"transient": 1, "hang": 1, "corruption": 1}
RECOVERY_FAILURES = {"step_error": 2, "hang": 1, "rebuild_fail": 1, "corruption": 1}


def recovery_size(entities: int = RECOVERY_ENTITIES, ticks: int = RECOVERY_TICKS) -> dict:
    check(ticks >= RECOVERY_FAULT_TICKS[-1] + 4,
          f"the fault schedule needs {RECOVERY_FAULT_TICKS[-1] + 4} ticks, not {ticks}")
    return dict(gateway_size(entities, ticks), storms=RECOVERY_FAULT_TICKS,
                deadline=RECOVERY_DEADLINE_S)


def uncounted(K, fn):
    """``fn()`` with the kernels' launch counts left as they were: a
    comparison of a kernel against its plain version is no launch of the
    path under test."""
    saved = K.launch_counts()
    try:
        return fn()
    finally:
        for name, wrapper in K.WRAPPERS.items():
            wrapper.launches = saved[name]


class RecoveryWorld(GatewayWorld):
    """10a: 6a's world armed with the device soak's schedule just before
    tick 0, the gateway's default backoffs and a snapshot path. Records
    every rebuild's verify and its host time (perf_counter: the run's
    monotonic clock is fixed), every snapshot the guard writes (read back)
    and every engine tick the guard ran."""

    HOLDS = True

    def __init__(self, dev: torch.device, clock, size: dict, snapshot_path: str):
        super().__init__(dev, clock, size)
        P, eng = self.P, self.eng
        guard = P.guard.guard
        P.settings.global_settings.snapshot_path = snapshot_path
        self.verified, self.rebuild_ms, self.snapshots = [], [], []
        self.engine_ticks = 0
        body, real_verify, real_snapshot, real_tick = (
            P.guard.DeviceGuard._rebuild_body, eng.verify_device_state, guard._snapshot, eng.tick)

        def timed_body(engine, seeds, gen, shadow=None):
            t0 = time.perf_counter()
            try:
                return body(engine, seeds, gen, shadow)
            finally:
                self.rebuild_ms.append((time.perf_counter() - t0) * 1e3)

        def recorded_verify(seeds):
            self.verified.append(real_verify(seeds))
            return self.verified[-1]

        def recorded_snapshot(reason, sync=False):
            real_snapshot(reason, sync=sync)
            self.snapshots.append((reason, len(P.snapshot.load_snapshot(snapshot_path).channels)))

        def counted_tick(*args, **kwargs):
            self.engine_ticks += 1
            return real_tick(*args, **kwargs)

        P.guard.DeviceGuard._rebuild_body = staticmethod(timed_body)
        eng.verify_device_state, guard._snapshot, eng.tick = (
            recorded_verify, recorded_snapshot, counted_tick)
        self._restore = lambda: (setattr(P.guard.DeviceGuard, "_rebuild_body", staticmethod(body)),
                                 delattr(guard, "_snapshot"))
        self.metrics_at_arm = P.invariants.scrape(P.metrics.registry)
        P.chaos.arm(fault_ticks_scenario(*size["storms"]))

    def metric_deltas(self) -> dict:
        """The guard's ledgers as the metrics counted them since arming."""
        inv, guard = self.P.invariants, self.P.guard.guard
        d = inv.delta(inv.scrape(self.P.metrics.registry), self.metrics_at_arm)
        return dict(recoveries={c: inv.sample_total(d, "device_recoveries_total", cause=c)
                                for c in guard.recovery_counts},
                    failures={c: inv.sample_total(d, "device_step_failures_total", cause=c)
                              for c in guard.failure_counts})

    def close(self) -> None:
        self.P.chaos.disarm()
        self._restore()
        super().close()


def outages(obs: list) -> list:
    """[(first, last)] runs of ticks the guard did not serve."""
    runs, start = [], None
    for t, o in enumerate(obs + [dict(served=True)]):
        if not o["served"] and start is None:
            start = t
        elif o["served"] and start is not None:
            runs.append((start, t - 1))
            start = None
    return runs


def run_recovery_leg(K, dev, size: dict, snapshot_path: str) -> tuple:
    """One leg of 10a: (per-tick observations, the leg's report). On the card
    K1 and K2 are held against their plain versions on the first tick the
    guard serves after each rebuild."""
    t_leg = time.perf_counter()
    with FixedClock() as clock:
        world = RecoveryWorld(dev, clock, size, snapshot_path)
        guard = world.P.guard.guard
        K.reset_launch_counts()
        obs, checked = [], []
        for t in range(size["ticks"]):
            rebuilds = len(world.verified)
            obs.append(world.tick(t))
            if dev.type == "cuda" and obs[-1]["served"] and checked and checked[-1] is None:
                uncounted(K, lambda: gateway_live_kernels(K, world.eng))
                checked[-1] = t
            if len(world.verified) > rebuilds:
                checked.append(None)
        report = dict(
            guard=guard.report(), verified=list(world.verified),
            rebuild_ms=list(world.rebuild_ms), snapshots=list(world.snapshots),
            census=world.census(), metrics=world.metric_deltas(),
            engine_ticks=world.engine_ticks, launches=K.launch_counts(), checked=checked,
            agents=world.eng.agent_count())
        world.close()
        del world
    report["secs"] = time.perf_counter() - t_leg
    return obs, report


def phase_recovery_lockstep(K, dev, cpu_leg: "CpuLeg") -> dict:
    """10a: the device soak's schedule through the port's gateway on the
    card and, at the same size (``cpu_leg.size``), on the CPU in
    ``cpu_leg``'s child, tick for tick. Returns K1/K2 launches on this
    path."""
    import os
    import shutil
    import tempfile

    size = cpu_leg.size
    ticks, scratch = size["ticks"], tempfile.mkdtemp(prefix="recovery-")
    legs, report = {}, {}
    t_phase = time.perf_counter()
    try:
        legs["cuda"], report["cuda"] = run_recovery_leg(K, dev, size,
                                                        os.path.join(scratch, "cuda.snap"))
        legs["cpu"], report["cpu"] = cpu_leg.result()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
        cpu_leg.close()
    card, cpu = legs["cuda"], legs["cpu"]
    check(len(card) == len(cpu), f"10a: {len(card)} card and {len(cpu)} cpu ticks")
    for t in range(ticks):
        where = first_gateway_diff(card[t], cpu[t])
        check(where is None, f"recovery tick {t}: cuda and cpu differ: {where}")
    for label, r in report.items():
        g = r["guard"]
        check(g["state"] == "ACTIVE", f"10a {label}: the guard ends {g['state']}")
        check(g["recovery_counts"] == RECOVERIES and g["failure_counts"] == RECOVERY_FAILURES,
              f"10a {label}: recoveries {g['recovery_counts']}, failures {g['failure_counts']}")
        check(r["metrics"] == dict(recoveries=g["recovery_counts"], failures=g["failure_counts"]),
              f"10a {label}: the ledgers {g['recovery_counts']} {g['failure_counts']} are not the "
              f"metrics' {r['metrics']}")
        check(len(r["verified"]) == 2 and all(v == [] for v in r["verified"]),
              f"10a {label}: rebuild verifies {r['verified']}")
        check(r["census"] == dict(misplaced=[], duplicated=[], untracked=[], ledger_off=[]),
              f"10a {label}: entities lost or duplicated: "
              f"{ {k: v[:5] for k, v in r['census'].items()} }")
        check([reason for reason, _ in r["snapshots"]] == ["device_fatal", "device_recovered"] * 2
              and all(n > size["entities"] for _, n in r["snapshots"]),
              f"10a {label}: snapshots {r['snapshots']}")
    down = [o["ladder"] for o in card if o["guard"][0] != "ACTIVE"]
    check(down and all(level >= 2 and floor == 2 for level, floor in down),
          f"10a: the ladder while the engine was down: {sorted(set(down))}")
    check(card[-1]["ladder"][1] == 0, f"10a: the ladder's floor stays {card[-1]['ladder'][1]}")
    runs = outages(card)
    check(len(runs) == 3, f"10a: outages {runs}, not one per cause")
    r = report["cuda"]
    check(r["checked"] and None not in r["checked"], f"10a: kernels checked after rebuilds at {r['checked']}")
    launches = r["launches"]
    for name, count in launches.items():
        check(count == r["engine_ticks"] > 0,
              f"10a: kernel {name} launched {count} times in {r['engine_ticks']} engine ticks")
    after = [t for t in range(runs[-1][1] + 1, ticks) if not card[t]["census"]]
    reads = sorted({card[t]["reads"] for t in after})
    check(reads == [2], f"10a: device reads per steady tick after recovery {reads}, not 2")
    first = RECOVERY_FAULT_TICKS[0]
    print(f"recovery lockstep: {ticks} GLOBAL ticks of {size['entities']} moving entity channels "
          f"(cut from 6a's {GATEWAY_ENTITIES}; storms of {size['entities'] // 8} at ticks "
          f"{size['storms']}), the sim plane's {r['agents']} agents, device_step_deadline_s "
          f"{RECOVERY_DEADLINE_S} on both legs, the device soak's schedule (transient errors at tick "
          f"{first}, a 3500 ms hang at {RECOVERY_FAULT_TICKS[1]} whose first rebuild fails, a "
          f"corruption at {RECOVERY_FAULT_TICKS[2]}) on cuda equal the CPU leg on every tick: "
          f"handovers ({sum(len(o['handovers']) for o in card)}), tables, every outbound stream, "
          f"changed rows, sim columns, the guard's state and ledgers, the ladder; both legs "
          f"recovered {RECOVERIES} (= device_recoveries_total), failures {RECOVERY_FAILURES} "
          f"(= device_step_failures_total), every rebuild verified clean, zero entities lost or "
          f"duplicated, ladder pinned at L2 through each outage and released, a snapshot on each "
          f"fatal and each recovery read back; K1 and K2 exact on the first tick after each "
          f"rebuild (ticks {r['checked']}); launches {launches} in {r['engine_ticks']} engine "
          f"ticks; phase {time.perf_counter() - t_phase:.1f} s (card leg {report['cuda']['secs']:.1f}"
          f" s, cpu leg {report['cpu']['secs']:.1f} s in a --cpu-leg child)")
    causes = ["transient", "hang", "corruption"]
    print("recovery outages (unserved ticks; card and cpu alike): " + "; ".join(
        f"{cause} ticks {a}-{b} ({b - a + 1} held or failed)" for cause, (a, b) in zip(causes, runs)))
    for label, leg in (("cuda", card), ("cpu", cpu)):
        rr = report[label]
        before = [o["step_ms"] for o in leg[1:first]]
        steady = [leg[t]["step_ms"] for t in range(runs[-1][1] + 1, ticks)]
        print(f"recovery on {label}: device_rebuild_ms by host clock (hang, corruption) "
              + ", ".join(f"{ms:.3f}" for ms in rr["rebuild_ms"])
              + f"; recovery_s by the fixed clock {rr['guard']['recovery_times_s']}; guarded step "
              f"median before the faults {statistics.median(before):.3f} ms, after "
              f"{statistics.median(steady):.3f} ms; snapshots {rr['snapshots']}")
    print(f"recovery reads per steady tick after recovery {reads}")
    return launches


# 10b: real device faults on the card. The wedge: a smaller world of 6a's
# kind (2,000 entities, 64 followers, 256 sensors, 64 subscribers, the sim
# plane) on the host's own clock; a kernel that keeps the card busy
# WEDGE_S inside the guarded window, once after the tick's kernels (the
# readback overruns the deadline) and once before them (the tick's own
# upload waits). The sticky error: a child process (``--sticky-child``).
WEDGE_SIZE = dict(entities=2_000, followers=64, sensors=256, subscribers=64, ticks=0,
                  census_every=1000, storms=(), deadline=RECOVERY_DEADLINE_S)
WEDGE_S = 3.5
STICKY_SIZE = dict(entities=256, followers=0, sensors=0, subscribers=0, ticks=0,
                   census_every=1000, storms=(), deadline=RECOVERY_DEADLINE_S, sim=False)


class WallClock:
    """A GatewayWorld clock that leaves ``time.monotonic`` alone: the
    guard's deadlines, backoffs and polls run on the host's time."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def advance(self, seconds: float) -> None:
        pass


class HeldWorld(GatewayWorld):
    HOLDS = True


def sleep_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles worth ``seconds`` on this card, from
    a timed short sleep."""
    probe = 20_000_000
    torch.cuda._sleep(probe)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    stop.record()
    stop.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(stop))


def phase_recovery_wedge(K, dev) -> list:
    """10b: a real wedge on the card, in the readback and in the tick's
    upload. Each: cause hang counted; the rebuild, queued behind the
    wedge on the same stream, completes only once it drained (polled
    across ticks); the zombie finishes late without touching the rebuilt
    state (the generation fence: it raises in the upload case); the
    rebuild verifies clean, again once the zombie is done; K1's counts
    equal the plain version on the next two ticks; no entity lost."""
    P = gateway_modules()
    results = []
    t_phase = time.perf_counter()
    with WallClock() as clock:
        world = HeldWorld(dev, clock, WEDGE_SIZE)
        eng, guard, dg = world.eng, P.guard.guard, P.guard
        try:
            t = 0
            for _ in range(3):
                world.tick(t)
                t += 1
            cycles = sleep_cycles(WEDGE_S)
            for n, where in enumerate(("readback", "flush"), start=1):
                real_tick, real_verify, real_log = eng.tick, eng.verify_device_state, dg._log_zombie
                drained, zombies, verified = [], [], []

                def wedged(*args, _where=where, _real=real_tick, **kwargs):
                    eng.tick = _real  # one wedge; the next tick is the rebuilt engine's
                    drained.append((time.perf_counter(), torch.cuda.Event()))
                    if _where == "flush":
                        torch.cuda._sleep(cycles)
                        drained[-1][1].record()
                        return _real(*args, **kwargs)
                    out = _real(*args, **kwargs)
                    torch.cuda._sleep(cycles)
                    drained[-1][1].record()
                    return out

                def recorded_verify(seeds, _real=real_verify):
                    errors = _real(seeds)
                    verified.append((errors, drained[0][1].query(), seeds, eng.generation,
                                     time.perf_counter()))
                    return errors

                eng.tick, eng.verify_device_state = wedged, recorded_verify
                dg._log_zombie = lambda fut, _real=real_log: (
                    zombies.append((repr(fut.exception()), time.perf_counter())), _real(fut))
                try:
                    world.tick(t)
                    t += 1
                    check(guard.failure_counts.get("hang") == n and guard.state.name != "ACTIVE",
                          f"10b {where}: the wedge was not taken for a hang: {guard.report()}")
                    polled = 0
                    while guard.state.name != "ACTIVE" and polled < 20:
                        world.tick(t)
                        t += 1
                        polled += 1
                    check(guard.state.name == "ACTIVE", f"10b {where}: not healed: {guard.report()}")
                    end = time.perf_counter() + 10.0
                    while not zombies and time.perf_counter() < end:
                        time.sleep(0.01)
                    check(zombies, f"10b {where}: the abandoned step never finished")
                    errors, after_drain, seeds, gen, healed = verified[0]
                    again = real_verify(seeds)
                    counts = []
                    for _ in range(2):
                        world.tick(t)
                        t += 1
                        want = K.assign_and_count_plain(eng.grid, eng._d_positions, eng._d_valid)[1]
                        counts.append(bool(torch.equal(eng.last_result["cell_counts"], want)))
                finally:
                    eng.tick, eng.verify_device_state, dg._log_zombie = (
                        real_tick, real_verify, real_log)
                check(len(verified) == 1 and errors == [] and after_drain,
                      f"10b {where}: rebuild verifies {[v[:2] for v in verified]}")
                check(again == [] and eng.generation >= gen,
                      f"10b {where}: after the zombie finished the rebuilt state verifies {again}")
                check(where == "readback" or "stale device tick" in zombies[0][0],
                      f"10b {where}: the zombie ended with {zombies[0][0]}, not the fence")
                check(counts == [True, True], f"10b {where}: K1's counts after recovery {counts}")
                results.append(dict(where=where, polled=polled,
                                    healed_s=healed - drained[0][0], zombie=zombies[0][0],
                                    zombie_s=zombies[0][1] - drained[0][0]))
            census = world.census()
            check(census == dict(misplaced=[], duplicated=[], untracked=[], ledger_off=[]),
                  f"10b: entities lost or duplicated: { {k: v[:5] for k, v in census.items()} }")
            check(guard.recovery_counts == {"hang": 2} and guard.failure_counts == {"hang": 2},
                  f"10b: recoveries {guard.recovery_counts}, failures {guard.failure_counts}")
        finally:
            world.close()
    for r in results:
        print(f"recovery wedge ({r['where']}): torch.cuda._sleep of {cycles} cycles (~{WEDGE_S} s) "
              f"on the engine's stream inside the guarded window, {WEDGE_SIZE['entities']} entities; "
              f"hang counted at the {RECOVERY_DEADLINE_S} s deadline, the rebuild queued behind the "
              f"wedge verified clean after it drained, {r['polled']} polled ticks, healed "
              f"{r['healed_s']:.3f} s after the wedge began; the zombie finished "
              f"{r['zombie_s']:.3f} s after it began with {r['zombie']}, the rebuilt state verified "
              f"clean again; K1's counts exact on the next two ticks; no entity lost")
    print(f"recovery wedge: phase {time.perf_counter() - t_phase:.1f} s")
    return results


def sticky_child() -> int:
    """10b's child (``chip_smoke.py --sticky-child``): a small guarded
    gateway world on ``cuda`` whose engine step hits a real device-side
    assert (an out-of-range index), which poisons the process's CUDA
    context. Prints one JSON report and exits 0 when the guard ended
    FAILED for good with readiness down and nothing escaped the loop
    thread, else 1."""
    import os

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report: dict = {"escaped": [], "messages": {}}
    try:
        with WallClock() as clock:
            world = HeldWorld(dev, clock, STICKY_SIZE)
        P, eng, ctl = world.P, world.eng, world.ctl
        guard, dg = P.guard.guard, P.guard
        real_classify, real_failed, real_tick, real_ctl_tick = (
            dg.classify_failure, guard._rebuild_failed, eng.tick, ctl.tick)

        def classify(exc):
            report["messages"].setdefault("step", str(exc))
            return real_classify(exc)

        def failed(exc):
            report["messages"].setdefault("rebuild", str(exc))
            return real_failed(exc)

        def poisoned(*args, **kwargs):
            eng.tick = real_tick
            index = torch.tensor([1 << 20], device=dev)
            torch.arange(4, device=dev)[index]  # out of range: a device-side assert
            return real_tick(*args, **kwargs)

        def loop_tick():
            try:
                real_ctl_tick()
            except Exception as e:  # noqa: BLE001 -- an escape is what this child reports
                report["escaped"].append(repr(e))

        dg.classify_failure, guard._rebuild_failed, ctl.tick = classify, failed, loop_tick
        chans = P.channel.all_channels()

        def tick(t: int) -> None:
            world.drive(t)
            now = time.monotonic_ns()
            for ch in world.entity_channels:
                ch.tick_once(now)
            P.channel.get_global_channel().tick_once(now)
            for cid in world.spatial:
                chans[cid].tick_once(now)

        for t in range(2):
            tick(t)
        report["before"] = guard.state.name
        eng.tick = poisoned
        tick(2)
        held = guard.held_ticks
        for t in range(3, 8):
            tick(t)
        ready, components = P.opshttp.readiness()
        doc = P.opshttp.introspect()
        from prometheus_client import generate_latest

        metrics = generate_latest(P.metrics.registry).decode()
        report.update(state=guard.state.name, failures=dict(guard.failure_counts),
                      recoveries=dict(guard.recovery_counts), held=guard.held_ticks - held,
                      ready=ready, device=components["device"], introspect_device=doc["device"],
                      sticky={k: dg.is_sticky_cuda_error(RuntimeError(v))
                              for k, v in report["messages"].items()},
                      metrics_device_state=[ln for ln in metrics.splitlines()
                                            if ln.startswith("device_state ")])
        ok = (report["before"] == "ACTIVE" and report["state"] == "FAILED"
              and report["failures"] == {"step_error": 1, "rebuild_fail": 1}
              and not report["recoveries"] and report["held"] == 5 and not ready
              and not report["escaped"] and all(report["sticky"].values())
              and set(report["sticky"]) == {"step", "rebuild"})
        guard.shutdown()
    except Exception as e:  # noqa: BLE001 -- reported to the parent, which fails the phase
        report["error"] = repr(e)
        ok = False
    report["ok"] = ok
    print(json.dumps(report))
    sys.stdout.flush()
    os._exit(0 if ok else 1)  # the poisoned context must not run teardown


def phase_recovery_sticky() -> dict:
    """10b: the sticky CUDA error, in a child so that this process's
    CUDA context survives; its report and exit code."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--sticky-child"], capture_output=True,
                          text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(lines, f"sticky child printed no report (exit {proc.returncode}): "
          f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    report = json.loads(lines[-1])
    check(proc.returncode == 0 and report.get("ok"),
          f"sticky child exit {proc.returncode}: {json.dumps(report)[:2000]} {proc.stderr[-800:]}")
    msg = report["messages"]["step"].splitlines()[0]
    print(f"recovery sticky error (child, {time.perf_counter() - t0:.1f} s, exit "
          f"{proc.returncode}): a real device-side assert in the engine step; the H100 said "
          f"{msg!r} (step) and {report['messages']['rebuild'].splitlines()[0]!r} (rebuild), both "
          f"matched as sticky; the guard ended {report['state']} for good, failures "
          f"{report['failures']}, no recovery, {report['held']} later ticks held, readiness "
          f"{report['ready']} ({report['device']['detail']}), {report['metrics_device_state']}, no "
          f"exception escaped the loop thread")
    return report


# 10c: the device soak's schedule on the host's clock in a live child
# gateway: the first fault once the child has booted and the world is
# claimed, the hang 7 s later as tests/test_device_guard.py's smoke soak
# spaces it, the corruption 9 s after the hang (the smoke soak's 6 s, plus
# room for the ladder to step down from L3, where the hang's 2 s tick can
# lift it and where it refuses the follower's new subscription).
LIVE_FAULTS_AT = (6.0, 13.0, 22.0)


def metric_values(text: str, name: str) -> dict:
    """{label string: value} of one metric in Prometheus text format."""
    out = {}
    for line in text.splitlines():
        if line.startswith((name + "{", name + " ")):
            key, _, value = line.rpartition(" ")
            out[key[len(name):]] = float(value)
    return out


class LiveGateway:
    """``python -m channeld_tpu_torch`` as a child, its log in a file, its
    ops surface on ``mport``, and the port's clients pumped while waiting."""

    def __init__(self, cmd: list, log_path: str, mport: int):
        import os

        self.cmd, self.log_path, self.mport = cmd, log_path, mport
        self.clients: list = []
        fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=fd, stderr=subprocess.STDOUT)
        os.close(fd)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def http(self, path: str) -> tuple:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.mport}{path}", timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()
        except OSError as e:
            return None, repr(e)

    def metric(self, name: str) -> dict:
        code, text = self.http("/metrics")
        return metric_values(text, name) if code == 200 else {}

    def until(self, cond, what: str, timeout: float):
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            for c in self.clients:
                c.tick(timeout=0.01)
            if cond():
                return
            check(self.proc.poll() is None, f"gateway child exited ({self.proc.returncode}) while "
                  f"waiting for {what}: {self.log()[-2000:]}")
            time.sleep(0.02)
        raise PhaseFailed(f"gateway child: no {what} within {timeout} s; log: {self.log()[-2000:]}")

    def connect(self, name: str, port: int, timeout: float = 30.0):
        """An authenticated client. A gateway whose overload ladder stands
        at L3 refuses admission (ServerBusy, then close): retried, as a
        real client retries."""
        from channeld_tpu_torch.client import Client

        end = time.perf_counter() + timeout
        while True:
            c = Client(f"127.0.0.1:{port}")
            self.clients.append(c)
            c.auth(login_token=name, pit=name)
            c.flush()
            try:
                self.until(lambda: c.id != 0 or not c.is_connected(), f"{name}'s auth", 5)
            except PhaseFailed:
                pass
            if c.id != 0:
                return c
            self.clients.remove(c)
            c.disconnect()
            check(time.perf_counter() < end, f"gateway child: {name} not admitted within {timeout} s")
            time.sleep(0.5)

    def stop(self) -> None:
        for c in self.clients:
            c.disconnect()
        self.clients = []
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def record(c, msg_type: int) -> list:
    box: list = []
    c.add_message_handler(msg_type, lambda _c, ch, m: box.append((ch, m)))
    return box


def claim_world(gw: "LiveGateway", sport: int, cport: int, deadline_s: float,
                n_servers: int = 9) -> dict:
    """A master creates GLOBAL, a client connects, ``n_servers`` servers
    claim the world (adopting any restored spatial channels)."""
    from channeld_tpu_torch.core.types import ChannelDataAccess, ChannelType, MessageType
    from channeld_tpu_torch.protocol import control_pb2

    gw.until(lambda: "listening for SERVER" in gw.log(), "server listener", deadline_s)
    ready_s = time.perf_counter() - gw.t0
    master = gw.connect("master", sport)
    created = record(master, MessageType.CREATE_CHANNEL)
    master.send(0, 0, MessageType.CREATE_CHANNEL,
                control_pb2.CreateChannelMessage(channelType=ChannelType.GLOBAL))
    gw.until(lambda: created, "GLOBAL's creation", 20)
    gw.until(lambda: gw.log().count("listening for CLIENT") >= 1, "client listener", 20)
    client = gw.connect("client", cport)
    servers, ready, handovers = [], [], []
    for i in range(n_servers):
        srv = gw.connect(f"spatial{i}", sport)
        ready.append(record(srv, MessageType.SPATIAL_CHANNELS_READY))
        handovers.append(record(srv, MessageType.CHANNEL_DATA_HANDOVER))
        srv.send(0, 0, MessageType.CREATE_CHANNEL, control_pb2.CreateChannelMessage(
            channelType=ChannelType.SPATIAL,
            subOptions=control_pb2.ChannelSubscriptionOptions(
                dataAccess=ChannelDataAccess.WRITE_ACCESS)))
        servers.append(srv)
    gw.until(lambda: all(ready), "SPATIAL_CHANNELS_READY on every server", 30)
    return dict(master=master, servers=servers, handovers=handovers, client=client,
                subs=record(client, MessageType.SUB_TO_CHANNEL),
                unsubs=record(client, MessageType.UNSUB_FROM_CHANNEL), ready_s=ready_s)


def cross(gw: "LiveGateway", world: dict, sender, eid: int, x: float, what: str,
          client_update: bool = True) -> None:
    """Move entity ``eid`` to (x, -14000) with one update from ``sender``;
    servers 0 and 1 (columns 0-4, 5-9) each get a handover, and the
    follower its interest update."""
    from channeld_tpu_torch.core.types import MessageType
    from channeld_tpu_torch.models import sim_pb2
    from channeld_tpu_torch.protocol import control_pb2
    from channeld_tpu_torch.utils.anyutil import pack_any

    h0, h1 = (len(world["handovers"][i]) for i in (0, 1))
    n_sub, n_unsub = len(world["subs"]), len(world["unsubs"])
    upd = sim_pb2.SimEntityChannelData()
    upd.state.entityId = eid
    upd.state.transform.position.x, upd.state.transform.position.z = x, -14000.0
    sender.send(eid, 0, MessageType.CHANNEL_DATA_UPDATE,
                control_pb2.ChannelDataUpdateMessage(data=pack_any(upd)))
    gw.until(lambda: len(world["handovers"][0]) > h0 and len(world["handovers"][1]) > h1,
             f"the handover on servers 0 and 1 {what}", 30)
    if client_update:
        gw.until(lambda: len(world["subs"]) > n_sub and len(world["unsubs"]) > n_unsub,
                 f"the follower's interest update {what}", 30)


def phase_recovery_live(dev_args=(), deadline_s: float = 180.0,
                        faults_at: tuple = LIVE_FAULTS_AT) -> dict:
    """10c: ``python -m channeld_tpu_torch`` on the card with ``-chaos``
    (the device soak's schedule), ``-snapshot``, ``-wal`` and
    ``-device-deadline 2``, driven over loopback TCP: after each
    recovery a crossing reaches both servers and the follower; the
    metrics and /readyz at the end; then SIGKILL, a restart without
    ``-chaos`` from the snapshot and WAL, the restored census equal to
    the one before the kill, a crossing after the restart, SIGTERM."""
    import os
    import shutil
    import signal
    import tempfile

    from channeld_tpu_torch.core.types import MessageType
    from channeld_tpu_torch.models import sim_pb2
    from channeld_tpu_torch.protocol import spatial_pb2
    from channeld_tpu_torch.utils.anyutil import pack_any

    t_phase = time.perf_counter()
    sport, cport, mport = free_port(), free_port(), free_port()
    scratch = tempfile.mkdtemp(prefix="recovery-live-")
    chaos_path = os.path.join(scratch, "device_soak.json")
    with open(chaos_path, "w") as f:
        json.dump(device_recovery_scenario(*faults_at), f)
    cmd = [sys.executable, "-m", "channeld_tpu_torch", "-dev", "-loglevel", "0",
           "-profilepath", scratch, "-sn", "tcp", "-sa", f"127.0.0.1:{sport}", "-cn", "tcp",
           "-ca", f"127.0.0.1:{cport}", "-mport", str(mport),
           "-cfsm", "config/client_authoritative_fsm.json", "-scc", GATEWAY_CONFIG,
           "-imports", "channeld_tpu_torch.models.sim", "-snapshot", os.path.join(scratch, "gw.snap"),
           "-wal", os.path.join(scratch, "gw.wal"), "-device-deadline", "2", *dev_args]
    log_path = os.path.join(scratch, "gateway.log")
    start, eid = 0x10000, 0x80000 + 1
    gw = LiveGateway(cmd + ["-chaos", chaos_path], log_path, mport)
    out: dict = {}
    try:
        world = claim_world(gw, sport, cport, deadline_s)
        out["ready_s"] = world["ready_s"]
        check("CHAOS ARMED" in gw.log(), "the child did not arm the chaos scenario")
        d = sim_pb2.SimEntityChannelData()
        d.state.entityId = eid
        d.state.transform.position.x, d.state.transform.position.z = -5100.0, -14000.0
        world["servers"][0].send(0, 0, MessageType.CREATE_ENTITY_CHANNEL,
                                 spatial_pb2.CreateEntityChannelMessage(entityId=eid, data=pack_any(d)))
        q = spatial_pb2.SpatialInterestQuery()
        q.sphereAOI.center.x, q.sphereAOI.center.z, q.sphereAOI.radius = -5100.0, -14000.0, 1500.0
        world["servers"][0].send(start + 4, 0, MessageType.UPDATE_SPATIAL_INTEREST,
                                 spatial_pb2.UpdateSpatialInterestMessage(
                                     connId=world["client"].id, query=q, followEntityId=eid))
        gw.until(lambda: {ch for ch, _ in world["subs"]} >= {start + 4, start + 5},
                 "the follower's interest (columns 4 and 5)", 20)
        out["world_s"] = time.perf_counter() - gw.t0
        # (recovery, the failure of the fault after it, where the crossing goes)
        steps = (("transient", "hang", -3100.0), ("hang", "corruption", -5100.0),
                 ("corruption", None, -3100.0))
        recovered_at = {}
        for cause, next_failure, x in steps:
            key = f'{{cause="{cause}"}}'
            gw.until(lambda: gw.metric("device_recoveries_total").get(key, 0) >= 1,
                     f"the {cause} recovery", 90)
            recovered_at[cause] = time.perf_counter() - gw.t0
            # At L3 the gateway refuses new subscriptions (ServerBusy) by
            # design: cross once the ladder admits the follower's again.
            gw.until(lambda: gw.metric("overload_level").get("", 3) < 3,
                     f"the overload ladder below L3 after the {cause} recovery", 60)
            cross(gw, world, world["servers"][0] if x > -5000 else world["servers"][1], eid, x,
                  f"after the {cause} recovery")
            if next_failure is not None:
                fired = gw.metric("device_step_failures_total").get(f'{{cause="{next_failure}"}}', 0)
                check(fired == 0, f"10c: the {next_failure} fault fired before the crossing after "
                      f"the {cause} recovery was served (faults at {faults_at} s come too early)")
        recoveries = gw.metric("device_recoveries_total")
        check(recoveries == {f'{{cause="{c}"}}': 1.0 for c in RECOVERIES},
              f"10c: device_recoveries_total {recoveries}")
        failures = gw.metric("device_step_failures_total")
        state = gw.metric("device_state")
        code, _ = gw.http("/readyz")
        check(state == {"": 0.0} and code == 200, f"10c: device_state {state}, /readyz {code}")
        code, body = gw.http("/introspect")
        before = json.loads(body)
        check(before["entities"] >= 1, f"10c: /introspect before the kill: {before}")
        gw.proc.send_signal(signal.SIGKILL)
        gw.proc.wait(timeout=20)
        gw.stop()

        gw = LiveGateway(cmd, os.path.join(scratch, "restarted.log"), mport)
        gw.until(lambda: gw.metric("tpu_spatial_step_seconds_count").get("", 0) >= 1,
                 "the restarted gateway's first served tick", deadline_s)
        served_s = time.perf_counter() - gw.t0
        code, body = gw.http("/introspect")
        after = json.loads(body)
        check((after["channels"], after["entities"]) == (before["channels"], before["entities"]),
              f"10c: restored census {after['channels']} / {after['entities']} entities, before the "
              f"kill {before['channels']} / {before['entities']}")
        world = claim_world(gw, sport, cport, deadline_s)
        cross(gw, world, world["master"], eid, -5100.0, "after the restart", client_update=False)
        gw.proc.send_signal(signal.SIGTERM)
        try:
            exit_code = gw.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"the restarted child did not exit within 30 s of SIGTERM: {gw.log()[-2000:]}")
        check(exit_code == 0, f"the restarted child exited {exit_code} on SIGTERM: {gw.log()[-2000:]}")
        replay = [ln for ln in gw.log().splitlines() if "boot replay" in ln]
        print(f"recovery live: python -m channeld_tpu_torch on "
              f"{'cuda' if not dev_args else ' '.join(dev_args)} with -chaos (the device soak's "
              f"schedule at {faults_at} s), -snapshot, -wal and -device-deadline 2, listening in "
              f"{out['ready_s']:.1f} s, world claimed at {out['world_s']:.1f} s; recoveries seen at "
              + ", ".join(f"{c} {t:.1f} s" for c, t in recovered_at.items())
              + f", each followed by a crossing handed over to servers 0 and 1 and the follower's "
              f"interest update; device_recoveries_total {recoveries}, device_step_failures_total "
              f"{failures}, device_state 0, /readyz 200; SIGKILL, restart without -chaos: first "
              f"served tick {served_s:.1f} s after the restart, /introspect census "
              f"{after['channels']} / {after['entities']} entities equal to before the kill "
              f"({replay[-1][-160:] if replay else 'no replay line'}), a crossing handed over after "
              f"the restart; SIGTERM exit 0; phase {time.perf_counter() - t_phase:.1f} s")
        out.update(recovered_at=recovered_at, served_s=served_s)
        return out
    finally:
        gw.stop()
        shutil.rmtree(scratch, ignore_errors=True)


# ---- phase 11: the elastic world -------------------------------------------

# 11a: phase 6a's world (config4 at the gateway's defaults: followers,
# sensors, clients and the sim plane) with adaptive partitioning on;
# 11b: config/spatial_tpu_cells_2x2.json's world on the cells plane at
# half the entities. Both on the port's copy of scripts/density_soak.py's
# phases (``elastic_scenario``), 120 ticks of the fixed 33 ms clock. Cut
# from 4,000 and 2,000 entities (283 s and 152 s on the card's host) to
# 800 and 400 by the script's time (1,500 and 750 before phase 12). ``--elastic ENTITIES TICKS`` runs
# 11a and 11b alone.
ELASTIC_ENTITIES, ELASTIC_TICKS = 800, 120
ELASTIC_CELLS_CONFIG = "config/spatial_tpu_cells_2x2.json"
ELASTIC_STALL_MS = 3500.0  # the hang on the re-planned split's commit tick, past the 2 s deadline
CELL_MSG_TYPES = (25, 26, 28)  # CellRehostedMessage, CellMigratedMessage, CellGeometryUpdateMessage


def elastic_scenario(entities: int, cols: int, rows: int, server_cols: int, server_rows: int,
                     ticks: int = ELASTIC_TICKS, hang: bool = True, weather: bool = False) -> dict:
    """The port's copy of scripts/density_soak.py's phases on a fixed
    clock, with the balance soak's granule migrations: warmup (spread),
    pileup (the whole crowd herded into one quarter of a base cell, so the
    cell splits and then its crowded child: the micro grid goes to depth
    2), repile (the crowd into a quarter of a second cell, whose owner is
    dropped on the tick its split starts draining; failover re-hosts the
    cell and the re-planned split commits, with a ``device.step_hang``
    on its commit tick when ``hang``), disperse (the crowd spreads; cold
    siblings consolidate and merge back to the boot geometry). The
    governor's and the balancer's knobs are scaled to the entity count;
    ``weather`` adds density_soak.default_scenario's dispatch stalls."""
    sc, sr = cols // server_cols, rows // server_rows
    warm, pile, repile = ticks // 12, ticks * 5 // 12, ticks * 7 // 12
    return dict(
        ticks=ticks, entities=entities,
        phases=dict(warmup=(0, warm), pileup=(warm, pile), repile=(pile, repile),
                    disperse=(repile, ticks)),
        # (col, row): the middle cell of the first server's block, then of the last's.
        pileup_cells=((sc // 2, sr // 2), (cols - sc + sc // 2, rows - sr + sr // 2)),
        recover_window_ms=100,
        # The ladder steps down a level after this long under its exit
        # threshold (the gateway's 2 s would hold L2, and veto every
        # merge, for 60 of the run's ticks after the hang).
        overload_down_hold_s=0.2,
        hang=dict(stall_ms=ELASTIC_STALL_MS, deadline_s=RECOVERY_DEADLINE_S) if hang else None,
        # A cell splits at a quarter of the crowd (a spread world never
        # comes near); a sibling group merges under an eighth (above a
        # spread world's base cell on the 4x4 grid, under half the split).
        partition=dict(enabled=True, split_entities=max(8, entities // 4),
                       merge_entities=max(2, entities // 8 - 1), max_depth=2, eval_ticks=1,
                       hold_ticks=2, epoch_ticks=40, budget_per_epoch=6, cooldown_ticks=10,
                       freeze_min_ticks=2, drain_deadline_ticks=30),
        balancer=dict(enabled=True, imbalance_enter=1.25, imbalance_exit=1.1, hold_ticks=2,
                      epoch_ticks=40, budget_per_epoch=3, cooldown_ticks=40,
                      # A spread world's noise never arms it; a crowd does.
                      min_entity_delta=max(8, entities // 4), freeze_min_ticks=2),
        weather=[{"point": "device.dispatch_stall", "every_n": 40, "stall_ms": 20,
                  "max_fires": 50}] if weather else [],
    )


def elastic_settings(scn: dict) -> dict:
    """The global settings the scenario runs under, by name."""
    out = {f"partition_{k}": v for k, v in scn["partition"].items()}
    out.update({f"balancer_{k}": v for k, v in scn["balancer"].items()})
    out.update(failover_enabled=True, server_conn_recoverable=True,
               server_conn_recover_timeout_ms=scn["recover_window_ms"],
               overload_down_hold_s=scn["overload_down_hold_s"])
    if scn["hang"] is not None:
        out["device_step_deadline_s"] = scn["hang"]["deadline_s"]
    return out


def elastic_chaos(scn: dict, hang: bool) -> dict:
    """The chaos scenario to arm: the weather, and the hang when ``hang``
    (armed on the tick it must land on: its first guarded step)."""
    faults = [dict(f) for f in scn["weather"]]
    if hang:
        faults.append({"point": "device.step_hang", "every_n": 1, "max_fires": 1,
                       "stall_ms": scn["hang"]["stall_ms"]})
    return {"name": "elastic", "seed": 20260807, "faults": faults}


def elastic_region(ctl, cell: tuple) -> tuple:
    """(x0, z0, x1, z1): the lower-left quarter of a base cell, a margin
    inside, so the crowd fills one child of a split and all four of that
    child's children."""
    col, row = cell
    w, h = ctl.grid_width, ctl.grid_height
    x, z = ctl.world_offset_x + col * w, ctl.world_offset_z + row * h
    return (x + 0.02 * w, z + 0.02 * h, x + 0.48 * w, z + 0.48 * h)


def elastic_moves(scn: dict, t: int, rng, ctl, ids: list, positions: dict) -> list:
    """[(entity, x, z)] of tick ``t``: a quarter of the entities walk
    (3% of a cell a step) while the world is spread; the whole crowd
    herds into the pileup region on the first tick of the pileup and of
    the repile, and an eighth of it jitters inside the region on their
    other ticks; the whole crowd spreads uniformly on the first tick of
    the disperse."""
    ph = scn["phases"]
    w, h = ctl.grid_width, ctl.grid_height
    x0, z0 = ctl.world_offset_x + 1.0, ctl.world_offset_z + 1.0
    x1 = ctl.world_offset_x + w * ctl.grid_cols - 1.0
    z1 = ctl.world_offset_z + h * ctl.grid_rows - 1.0
    crowd = None
    if ph["pileup"][0] <= t < ph["pileup"][1]:
        crowd = elastic_region(ctl, scn["pileup_cells"][0])
        first = t == ph["pileup"][0]
    elif ph["repile"][0] <= t < ph["repile"][1]:
        crowd = elastic_region(ctl, scn["pileup_cells"][1])
        first = t == ph["repile"][0]
    if crowd is not None:
        cx0, cz0, cx1, cz1 = crowd
        if first:
            return [(e, rng.uniform(cx0, cx1), rng.uniform(cz0, cz1)) for e in ids]
        out = []
        for e in rng.sample(ids, max(1, len(ids) // 8)):
            x, z = positions[e]
            out.append((e, min(max(x + rng.uniform(-0.03, 0.03) * w, cx0), cx1),
                        min(max(z + rng.uniform(-0.03, 0.03) * h, cz0), cz1)))
        return out
    if t == ph["disperse"][0]:
        return [(e, rng.uniform(x0, x1), rng.uniform(z0, z1)) for e in ids]
    out = []
    for e in rng.sample(ids, max(1, len(ids) // 4)):
        x, z = positions[e]
        out.append((e, min(max(x + rng.uniform(-0.03, 0.03) * w, x0), x1),
                    min(max(z + rng.uniform(-0.03, 0.03) * h, z0), z1)))
    return out


def elastic_trigger(scn: dict, t: int, state: dict, ctl, partition, journal,
                    spatial_start: int) -> Optional[str]:
    """'kill', 'hang' or None for tick ``t``, decided before the tick from
    what the partition plane holds: the repile cell's first split is
    draining (drop its owner now: the split aborts this tick); or the
    re-planned split will commit this tick (arm the hang)."""
    col, row = scn["pileup_cells"][1]
    target = spatial_start + row * ctl.grid_cols + col
    ph = scn["phases"]
    op = partition.op_in_flight()
    if (op is None or op.op != "split" or op.target != target or op.state != "draining"
            or t < ph["repile"][0]):
        return None
    if "killed" not in state:
        state["killed"] = (t, op.op_id)
        return "kill"
    if (scn["hang"] is not None and "hung" not in state and op.op_id != state["killed"][1]
            and partition._tick + 1 - op.planned_tick >= scn["partition"]["freeze_min_ticks"]
            and not journal.in_flight_touching(target)):
        state["hung"] = (t, op.op_id)
        return "hang"
    return None


def elastic_state(ctl, partition, balancer, failover, journal) -> tuple:
    """What the elastic planes hold after a tick, for the per-tick
    comparison: the geometry epoch and splits, the micro grid, the
    partition, balancer and failover ledgers, the journal's counts, the
    deferred and frozen crossings and the frozen cells."""
    return (ctl.geometry_epoch, sorted(ctl.tree.splits), (ctl._mcols, ctl._mrows),
            sorted(partition.ledger.items()), sorted(balancer.ledger.items()),
            sorted(failover.ledger.items()), sorted(journal.counts.items()),
            sorted(ctl._deferred_crossings), sorted(balancer._frozen_crossings),
            sorted(balancer.frozen_cells))


class ElasticConn(GatewayConn):
    """A stub that also digests the cell-authority messages it is sent
    (re-host, migration, geometry update) apart, and that a kill leaves
    recoverable, as a server socket's abnormal close does."""

    def __init__(self, P, conn_id: int, kind: str):
        super().__init__(P, conn_id, kind)
        self.cell_digest = hashlib.sha256()
        self.cell_count = 0

    def send(self, ctx) -> None:
        super().send(ctx)
        if ctx.msg_type in CELL_MSG_TYPES:
            body = ctx.raw_body
            if body is None:
                body = ctx.msg.SerializeToString(deterministic=True) if ctx.msg is not None else b""
            self.cell_digest.update(np.array([ctx.msg_type, ctx.channel_id, len(body)],
                                             np.int64).tobytes())
            self.cell_digest.update(body)
            self.cell_count += 1

    def should_recover(self) -> bool:
        return self.recover_handle is not None


def elastic_size(entities: int = ELASTIC_ENTITIES, ticks: int = ELASTIC_TICKS,
                 mesh: bool = False, config: str = GATEWAY_CONFIG) -> dict:
    """11a's (or, ``mesh``, 11b's) world and scenario."""
    with open(config) as f:
        c = json.load(f)["Config"]
    scn = elastic_scenario(entities, c["GridCols"], c["GridRows"], c["ServerCols"],
                           c["ServerRows"], ticks, hang=not mesh, weather=mesh)
    size = dict(gateway_size(entities, ticks), storms=(), census_every=40, config=config,
                scenario=scn, settings=elastic_settings(scn), deadline=RECOVERY_DEADLINE_S)
    if mesh:
        size.update(sim=False, followers=64, sensors=256, subscribers=64)
    return size


class ElasticWorld(GatewayWorld):
    """11a/11b: the gateway world with the partition, balancer and
    failover planes on ``elastic_scenario``'s schedule. Records every
    geometry epoch (its tick, micro grid, the rebuild's verify metric and
    the host time of ``on_geometry_changed``), every engine tick, and,
    on the card, checks K1 and K2 against their plain versions on the
    live tensors after each tick that re-gridded the engine (uncounted,
    outside the tick's timed window)."""

    HOLDS = True

    def __init__(self, dev: torch.device, clock, size: dict, K=None):
        self.scn = size["scenario"]
        self.K = K
        super().__init__(dev, clock, size)
        P, ctl, eng = self.P, self.ctl, self.eng
        P.tracing.recorder.configure(enabled=False)
        self.trigger, self.fired = {}, []
        self.epochs, self.engine_ticks, self.kernel_checks = [], 0, []
        self.t = -1
        real_changed, real_tick = ctl.on_geometry_changed, eng.tick
        inv = P.invariants

        def recorded_changed():
            old = (ctl._mcols, ctl._mrows)
            before = inv.scrape(P.metrics.registry)
            t0 = time.perf_counter()
            real_changed()
            ms = (time.perf_counter() - t0) * 1e3
            d = inv.delta(inv.scrape(P.metrics.registry), before)
            self.epochs.append(dict(
                tick=self.t, epoch=ctl.geometry_epoch, micro=(ctl._mcols, ctl._mrows), old=old,
                verified=int(inv.sample_total(d, "partition_device_rebuilds_total",
                                              result="verified")),
                mismatch=int(inv.sample_total(d, "partition_device_rebuilds_total",
                                              result="mismatch")), ms=ms))

        def counted_tick(*args, **kwargs):
            self.engine_ticks += 1
            return real_tick(*args, **kwargs)

        ctl.on_geometry_changed, eng.tick = recorded_changed, counted_tick
        if self.scn["weather"]:
            P.chaos.arm(elastic_chaos(self.scn, hang=False))

    @property
    def spatial(self) -> list:
        """The live spatial channels (leaves of the cell tree), re-read on
        every use: a geometry epoch creates and retires them mid-tick."""
        st = self.P.settings.global_settings
        lo, hi = st.spatial_channel_id_start, st.entity_channel_id_start
        return sorted(cid for cid, ch in self.P.channel.all_channels().items()
                      if lo <= cid < hi and not ch.is_removing())

    @spatial.setter
    def spatial(self, _boot: list) -> None:
        pass

    def conn(self, conn_id: int, kind: str) -> GatewayConn:
        c = ElasticConn(self.P, conn_id, kind)
        self.P.connection._all_connections[conn_id] = c
        self.conns.append(c)
        return c

    def drive(self, t: int) -> None:
        P, ctl = self.P, self.ctl
        self.t = t
        P.recovery.tick_connection_recovery_once()  # the reaper loop's pass
        start = P.settings.global_settings.spatial_channel_id_start
        action = elastic_trigger(self.scn, t, self.trigger, ctl, P.partition.partition,
                                 P.failover.journal, start)
        for eid, x, z in elastic_moves(self.scn, t, self.rng, ctl, self.entity_ids,
                                       self.positions):
            self.move(eid, x, z)
        if action == "kill":
            op = P.partition.partition.op_in_flight()
            owner = P.channel.get_channel(op.target).get_owner()
            P.recovery.make_recoverable(owner)
            owner.close(unexpected=True)
            P.connection._all_connections.pop(owner.id, None)
            P.connection.close_epoch += 1  # the channels' prune scans key off it
            self.fired.append((t, "kill", owner.id))
        elif action == "hang":
            P.chaos.arm(elastic_chaos(self.scn, hang=True))
            self.fired.append((t, "hang", None))

    def tick(self, t: int) -> dict:
        P, ctl = self.P, self.ctl
        epochs = len(self.epochs)
        failures = dict(P.guard.guard.failure_counts)
        state = P.guard.guard.state.name
        obs = super().tick(t)
        regrid = [e for e in self.epochs[epochs:] if e["micro"] != e["old"]]
        if regrid and self.K is not None and self.dev.type == "cuda":
            # Outside the tick's timed window.
            self.kernel_checks.append(uncounted(self.K, lambda: elastic_live_kernels(
                self.K, self.eng, regrid[-1]["micro"])))
        obs["elastic"] = elastic_state(ctl, P.partition.partition, P.balancer.balancer,
                                       P.failover.plane, P.failover.journal)
        obs["cell_msgs"] = {c.id: (c.cell_count, c.cell_digest.hexdigest()) for c in self.conns}
        obs["epoch_tick"] = len(self.epochs) > epochs
        obs["steady"] = (obs["served"] and not obs["census"] and not obs["epoch_tick"]
                         and state == "ACTIVE" and P.guard.guard.state.name == "ACTIVE"
                         and dict(P.guard.guard.failure_counts) == failures)
        return obs

    def elastic_census(self) -> dict:
        """``census`` over the live leaf channels, and the journal: its
        prepared less committed and aborted records, and those in flight."""
        jc = self.P.failover.journal.counts
        return dict(self.census(), journal=(
            jc.get("prepared", 0) - jc.get("committed", 0) - jc.get("aborted", 0),
            self.P.failover.journal.in_flight_count()))

    def close(self) -> None:
        self.P.chaos.disarm()
        super().close()


def elastic_live_kernels(K, eng, micro: tuple) -> dict:
    """K1 and K2 against their plain versions on the engine's live tensors
    after a geometry epoch (a meshed engine: its first shard's slots, and
    its last shard's block with the cells plane's fused centre), exact,
    with each kernel's time alone (bare launches, events), its plain
    version's and its bound."""
    grid, qs = eng.grid, eng._d_queries
    mesh = eng._mesh
    pos, valid = eng._d_positions, eng._d_valid
    if mesh is not None:
        from channeld_tpu_torch.parallel.spatial_alltoall import cells_per_shard

        pos, valid = pos[0], valid[0]
        blk = cells_per_shard(grid, mesh.size)
        base, fused = (mesh.size - 1) * blk, True
    else:
        base, blk, fused = 0, grid.num_cells, False
    n, c = pos.shape[0], grid.num_cells
    err1 = max_abs_diff(zip(K.assign_and_count(grid, pos, valid),
                            K.assign_and_count_plain(grid, pos, valid)))
    args = (qs.kind, qs.center, qs.extent, qs.direction, torch.cos(qs.angle))
    err2 = max_abs_diff(zip(K.aoi_tile(grid, *args, base, blk, fused_centre=fused),
                            K.aoi_tile_plain(grid, *args, base, blk, fused_centre=fused)))
    check(err1 == 0 and err2 == 0, f"after the epoch to {micro[0]}x{micro[1]}: K1 |diff| {err1}, "
                                   f"K2 {err2} on the live tensors")
    q = args[0].shape[0]
    ids = [i for i in range(base, base + blk) if i < c]
    axes = len({i % grid.cols for i in ids}) + len({i // grid.cols for i in ids})
    b1, by1 = bound_ms(pos.numel() * 4 + n + 4 * n + 4 * c, ASSIGN_OPS_PER_SLOT * n)
    b2, by2 = bound_ms(q * (4 + 3 * 8 + 4) + q * blk * 5,
                       AOI_OPS_PER_PAIR * q * len(ids) + AOI_OPS_PER_AXIS * q * axes)
    return {
        "assign_count": dict(
            shape=f"{n} slots x {c} bins", micro=micro, max_abs_err=err1, bound_ms=b1,
            bound_by=by1, shared=K.uses_shared_histogram(grid, pos.device),
            ms=queued_ms(K.prepare_assign_count(grid, pos, valid).run),
            plain_ms=median_ms(lambda: K.assign_and_count_plain(grid, pos, valid), reps=20,
                               warmup=2), library_ms=None),
        "aoi": dict(
            shape=f"{q} x {blk} pairs" + (f" (cell_base {base} of {c}, fused centre)"
                                          if mesh is not None else ""),
            micro=micro, max_abs_err=err2, bound_ms=b2, bound_by=by2,
            ms=queued_ms(K.prepare_aoi(grid, *args, base, blk, fused_centre=fused).run,
                         reps=200 if q * blk < 1 << 22 else 40),
            plain_ms=median_ms(lambda: K.aoi_tile_plain(grid, *args, base, blk,
                                                        fused_centre=fused),
                               reps=10, warmup=2), library_ms=None),
    }


def run_elastic_leg(K, leg: str, leg_dev, size: dict, label: str) -> tuple:
    """One leg of 11a/11b: (per-tick observations, the leg's report)."""
    t_leg = time.perf_counter()
    with FixedClock() as clock:
        world = ElasticWorld(leg_dev, clock, size, K=K)
        P = world.P
        K.reset_launch_counts()
        obs = [world.tick(t) for t in range(size["ticks"])]
        launches = K.launch_counts()
        part, bal = P.partition.partition, P.balancer.balancer
        report = dict(
            launches=launches, engine_ticks=world.engine_ticks, epochs=list(world.epochs),
            fired=list(world.fired), census=world.elastic_census(),
            partition=dict(part.ledger), events=[dict(e) for e in part.events],
            balancer=dict(bal.ledger), failover=dict(P.failover.plane.ledger),
            splits=sorted(world.ctl.tree.splits),
            micro=(world.ctl._mcols, world.ctl._mrows), guard=P.guard.guard.report(),
            kernel_checks=list(world.kernel_checks), agents=world.eng.agent_count(),
            shards=world.eng._mesh.size if world.eng._mesh is not None else 1,
            in_flight=(part.op_in_flight(), bal.migration_in_flight()))
        world.close()
        del world
    report["secs"] = time.perf_counter() - t_leg
    return obs, report


def phase_elastic_lockstep(K, dev, cpu_leg: "CpuLeg") -> tuple:
    """11a/11b (``cpu_leg.phase``): ``elastic_scenario`` through the port's
    gateway on the card and, at the same size (``cpu_leg.size``), on the
    CPU in ``cpu_leg``'s child, tick for tick, and the density soak's
    invariants on both legs. Returns (K1/K2 launches on this path, the
    kernels' entries at the post-split shapes)."""
    size, label = cpu_leg.size, cpu_leg.phase
    scn, ticks = size["scenario"], size["ticks"]
    mesh = label == "11b"
    legs, report = {}, {}
    t_phase = time.perf_counter()
    try:
        legs["cuda"], report["cuda"] = run_elastic_leg(K, "cuda", dev, size, label)
        legs["cpu"], report["cpu"] = cpu_leg.result()
    finally:
        cpu_leg.close()
    card, cpu = legs["cuda"], legs["cpu"]
    for t in range(ticks):
        where = first_gateway_diff(card[t], cpu[t])
        if where is not None:
            print(f"MISMATCH {label} tick {t}: {where}")
        check(where is None, f"{label} tick {t}: cuda and cpu differ: {where}")
    for leg in ("cuda", "cpu"):
        r = report[leg]
        p = r["partition"]
        check(p.get("split_committed", 0) >= 2 and p.get("merge_committed", 0) >= 2,
              f"{label} {leg}: partition ledger {p}")
        check(p.get("split_aborted", 0) == 1, f"{label} {leg}: splits aborted {p}, not exactly 1")
        aborted = [e for e in r["events"] if e["result"] == "aborted" and e["op"] == "split"]
        check(aborted and aborted[0]["reason"] == "dst_dead",
              f"{label} {leg}: the aborted split {aborted}")
        for op in ("split", "merge"):
            check(p.get(f"{op}_planned", 0) == p.get(f"{op}_committed", 0)
                  + p.get(f"{op}_aborted", 0), f"{label} {leg}: {op}s planned != committed + "
                  f"aborted: {p}")
        check(r["balancer"].get("committed", 0) >= 1, f"{label} {leg}: balancer {r['balancer']}")
        check(r["failover"]["cells_rehosted"] >= 1, f"{label} {leg}: failover {r['failover']}")
        check(r["splits"] == [] and r["micro"] == card[0]["elastic"][2],
              f"{label} {leg}: ends on splits {r['splits'][:8]}, micro grid {r['micro']}, not the "
              f"boot geometry")
        check(r["in_flight"] == (None, None), f"{label} {leg}: ops left in flight {r['in_flight']}")
        check(r["census"] == dict(misplaced=[], duplicated=[], untracked=[], ledger_off=[],
                                  journal=(0, 0)),
              f"{label} {leg}: entities lost, duplicated or in flight: "
              f"{ {k: v if isinstance(v, tuple) else v[:5] for k, v in r['census'].items()} }")
        check(r["epochs"] and all(e["verified"] == (e["micro"] != e["old"]) and e["mismatch"] == 0
                                  for e in r["epochs"]),
              f"{label} {leg}: epochs (a re-grid's rebuild verified, no mismatch) {r['epochs']}")
        check(r["guard"]["state"] == "ACTIVE", f"{label} {leg}: the guard ends {r['guard']['state']}")
    r = report["cuda"]
    check([e[1] for e in r["fired"]] == (["kill"] if mesh else ["kill", "hang"]),
          f"{label}: fired {r['fired']}")
    depths = sorted({e["micro"] for e in r["epochs"]})
    base = card[0]["elastic"][2]
    check((base[0] * 4, base[1] * 4) in depths and (base[0] * 2, base[1] * 2) in depths,
          f"{label}: micro grids {depths} do not reach depth 2")
    if not mesh:
        hang_tick = r["fired"][1][0]
        check(any(e["tick"] == hang_tick for e in r["epochs"]),
              f"{label}: no epoch committed on the hang tick {hang_tick}")
        check(r["guard"]["recovery_counts"] == {"hang": 1},
              f"{label}: recoveries {r['guard']['recovery_counts']}")
    want = r["engine_ticks"] * r["shards"]
    for name, count in r["launches"].items():
        check(count == want > 0, f"{label}: kernel {name} launched {count} times in "
              f"{r['engine_ticks']} engine ticks x {r['shards']} shards")
    # Reads per steady tick before the first re-grid and after each one
    # (up to the next): each span's set of counts.
    regrids = [e["tick"] for e in r["epochs"] if e["micro"] != e["old"]]
    per_span = []
    for a, b in zip([0] + regrids, regrids + [ticks]):
        per_span.append(sorted({card[t]["reads"] for t in range(a + 1, b) if card[t]["steady"]}))
    check(all(rd == [2] for rd in per_span) and len(per_span) == len(regrids) + 1,
          f"{label}: device reads per steady tick before and after each re-grid {per_span}")
    entries = {}
    for chk in r["kernel_checks"]:
        for name, e in chk.items():
            entries.setdefault(name, {})[f"{e['micro'][0]}x{e['micro'][1]}"] = e
    overflow = sum(o["overflow"] for o in card)
    if mesh:
        check(overflow > 0, f"{label}: the bucket never overflowed")
    print(f"{label} elastic lockstep: {ticks} GLOBAL ticks of {scn['entities']} entity channels on "
          f"{size['config']} ({r['shards']} shard(s){', Sharding cells, CellBucket ' if mesh else ''}"
          f"{size.get('bucket', '') if mesh else ''}; sim agents {r['agents']}) on the port's "
          f"copy of the density soak's schedule (pileup into {scn['pileup_cells'][0]} at "
          f"{scn['phases']['pileup'][0]}, repile into {scn['pileup_cells'][1]} at "
          f"{scn['phases']['repile'][0]}, disperse at {scn['phases']['disperse'][0]}; fired "
          f"{r['fired']}) on cuda equal the CPU leg on every tick: handovers "
          f"({sum(len(o['handovers']) for o in card)}), tables, every outbound stream, the "
          f"cell-authority messages, geometry epoch and micro grid, the partition, balancer and "
          f"failover ledgers and the journal; partition {r['partition']}; balancer "
          f"{r['balancer']}; failover {r['failover']}; epochs (tick, micro grid, verified, "
          f"on_geometry_changed ms) "
          + ", ".join(f"({e['tick']}, {e['micro'][0]}x{e['micro'][1]}, {e['verified']}, "
                      f"{e['ms']:.3f})" for e in r["epochs"])
          + f"; zero entities lost or duplicated, journal balanced; launches {r['launches']} in "
          f"{r['engine_ticks']} engine ticks; reads per steady tick before and after each re-grid "
          f"(ticks {regrids}) {per_span}; "
          f"overflow {overflow}; phase {time.perf_counter() - t_phase:.1f} s (card leg "
          f"{report['cuda']['secs']:.1f} s, cpu leg {report['cpu']['secs']:.1f} s in a --cpu-leg "
          f"child)")
    ph = scn["phases"]
    spread = [t for t in (*range(*ph["warmup"]), *range(*ph["disperse"])) if card[t]["steady"]]
    for leg, obs in (("cuda", card), ("cpu", cpu)):
        rr = report[leg]
        pile = [obs[t]["tick_ms"] for t in range(*ph["pileup"])]
        held = sum(1 for o in obs if not o["served"])
        print(f"{label} on {leg}: tick median/p99 spread (steady ticks of the warmup and the "
              f"disperse) {tick_stats([obs[t]['tick_ms'] for t in spread])}, pileup "
              f"{tick_stats(pile)}; guarded step {tick_stats([o['step_ms'] for o in obs if o['step_ms'] is not None])}; "
              f"apply_grid + verify (on_geometry_changed, host clock) "
              + ", ".join(f"{e['ms']:.3f}" for e in rr["epochs"])
              + f" ms; held ticks {held}; guard recoveries {rr['guard']['recovery_counts']}")
    for name, shapes in entries.items():
        for shape, e in shapes.items():
            print(f"{label} {name} after the epoch to {shape} ({e['shape']}): exact; alone "
                  f"{e['ms']:.4f} ms (events, bare launches), plain {e['plain_ms']:.4f} ms, bound "
                  f"{e['bound_ms']:.5f} ms ({e['bound_by']})")
    return r["launches"], entries


def elastic_mesh_size(scratch: str, entities: int = ELASTIC_ENTITIES // 2,
                      ticks: int = ELASTIC_TICKS, n_dev: Optional[int] = None) -> dict:
    """11b's size: config/spatial_tpu_cells_2x2.json at MeshDevices = n_dev
    (default min(cards, 8)) and a CellBucket the pileup overflows, written
    into ``scratch``."""
    if n_dev is None:
        n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
    with open(ELASTIC_CELLS_CONFIG) as f:
        cfg = json.load(f)
    bucket = max(1, (entities * 15) // (16 * n_dev))
    cfg["Config"].update(MeshDevices=n_dev, CellBucket=bucket)
    path = f"{scratch}/spatial_tpu_cells_elastic.json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return dict(elastic_size(entities, ticks, mesh=True, config=path), bucket=bucket)


def phase_elastic_mesh(K, cpu_leg: "CpuLeg", dev=None) -> tuple:
    """11b: ``elastic_scenario`` on config/spatial_tpu_cells_2x2.json's
    world (Sharding cells) at MeshDevices = min(cards, 8), the CPU leg at
    the same mesh in ``cpu_leg``'s child, with the density soak's
    dispatch-stall weather and a CellBucket the pileup overflows (on a mesh
    of one, every tick, as 7c's)."""
    return phase_elastic_lockstep(K, dev if dev is not None else torch.device("cuda", 0), cpu_leg)


ELASTIC_LIVE = dict(entities=64, split=32, merge=8)


def phase_elastic_live(dev_args=(), deadline_s: float = 180.0, size: dict = ELASTIC_LIVE) -> dict:
    """11c: ``python -m channeld_tpu_torch`` on the cells plane
    (config/spatial_tpu_cells_2x2.json at MeshDevices = min(cards, 8))
    with ``-partition true`` (depth 1, split and merge thresholds scaled to
    the entities), ``-chaos`` (the density soak's dispatch stalls),
    ``-overload false`` (as the density soak) and ``-mport``, driven over
    loopback TCP: a master and the 4 servers claim
    the world, the master spawns entities over it and herds them into one
    cell; /metrics must show a committed split, its re-grid verified (no
    mismatch), a committed balancer migration and ``device_state`` 0; the
    crowd disperses and the cell merges back (a second verified
    re-grid); SIGTERM ends the child with exit code 0."""
    import os
    import shutil
    import signal
    import tempfile
    from random import Random

    from channeld_tpu_torch.core.types import MessageType
    from channeld_tpu_torch.models import sim_pb2
    from channeld_tpu_torch.protocol import control_pb2, spatial_pb2
    from channeld_tpu_torch.utils.anyutil import pack_any

    t_phase = time.perf_counter()
    n_dev = 1 if dev_args else min(torch.cuda.device_count(), MESH_SHARDS)
    sport, cport, mport = free_port(), free_port(), free_port()
    scratch = tempfile.mkdtemp(prefix="elastic-live-")
    with open(ELASTIC_CELLS_CONFIG) as f:
        cfg = json.load(f)
    cfg["Config"].update(MeshDevices=n_dev)
    config_path = os.path.join(scratch, "spatial_tpu_cells.json")
    with open(config_path, "w") as f:
        json.dump(cfg, f)
    chaos_path = os.path.join(scratch, "density_weather.json")
    with open(chaos_path, "w") as f:
        json.dump(elastic_chaos(elastic_scenario(size["entities"], 4, 4, 2, 2, hang=False,
                                                 weather=True), hang=False), f)
    cmd = [sys.executable, "-m", "channeld_tpu_torch", "-dev", "-loglevel", "0",
           "-profilepath", scratch, "-sn", "tcp", "-sa", f"127.0.0.1:{sport}", "-cn", "tcp",
           "-ca", f"127.0.0.1:{cport}", "-mport", str(mport),
           "-cfsm", "config/client_authoritative_fsm.json", "-scc", config_path,
           "-imports", "channeld_tpu_torch.models.sim", "-partition", "true",
           "-partition-split", str(size["split"]), "-partition-merge", str(size["merge"]),
           "-partition-depth", "1", "-partition-budget", "4", "-chaos", chaos_path,
           # As scripts/density_soak.py pins it: the ladder's veto of
           # geometry ops at L2+ has its own tests, and a slow first tick
           # must not mask the ops under test.
           "-overload", "false", *dev_args]
    gw = LiveGateway(cmd, os.path.join(scratch, "gateway.log"), mport)
    rng = Random(SEED + 11)
    try:
        world = claim_world(gw, sport, cport, deadline_s, n_servers=4)
        check("CHAOS ARMED" in gw.log(), "11c: the child did not arm the chaos scenario")
        master = world["master"]
        x0, z0, w = cfg["Config"]["WorldOffsetX"], cfg["Config"]["WorldOffsetZ"], cfg["Config"]["GridWidth"]
        span = w * cfg["Config"]["GridCols"]
        eids = [0x80000 + 1 + i for i in range(size["entities"])]

        def data(eid, x, z):
            d = sim_pb2.SimEntityChannelData()
            d.state.entityId = eid
            d.state.transform.position.x, d.state.transform.position.z = x, z
            return d

        def move_all(place) -> None:
            for eid in eids:
                x, z = place()
                master.send(eid, 0, MessageType.CHANNEL_DATA_UPDATE,
                            control_pb2.ChannelDataUpdateMessage(data=pack_any(data(eid, x, z))))
            master.flush()

        def metric(name: str, **labels) -> float:
            key = "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}" if labels else ""
            return gw.metric(name).get(key, 0.0)

        spread = lambda: (rng.uniform(x0 + 1, x0 + span - 1), rng.uniform(z0 + 1, z0 + span - 1))  # noqa: E731
        for eid in eids:
            x, z = spread()
            master.send(0, 0, MessageType.CREATE_ENTITY_CHANNEL, spatial_pb2.CreateEntityChannelMessage(
                entityId=eid, data=pack_any(data(eid, x, z))))
        master.flush()
        gw.until(lambda: metric("tpu_entities") >= size["entities"], "every entity tracked", 30)
        spawned_s = time.perf_counter() - gw.t0
        # The crowd: the interior of base cell (1, 1).
        cx0, cz0 = x0 + w + 1.0, z0 + w + 1.0
        move_all(lambda: (rng.uniform(cx0, cx0 + w - 2.0), rng.uniform(cz0, cz0 + w - 2.0)))
        gw.until(lambda: metric("partition_ops_total", op="split", result="committed") >= 1,
                 "a committed split", 60)
        split_s = time.perf_counter() - gw.t0
        gw.until(lambda: metric("balancer_migrations_total", result="committed") >= 1,
                 "a committed balancer migration", 60)
        migrated_s = time.perf_counter() - gw.t0
        verified = metric("partition_device_rebuilds_total", result="verified")
        mismatch = metric("partition_device_rebuilds_total", result="mismatch")
        check(verified >= 1 and mismatch == 0,
              f"11c: partition_device_rebuilds_total verified {verified}, mismatch {mismatch}")
        check(gw.metric("device_state") == {"": 0.0}, f"11c: device_state {gw.metric('device_state')}")
        move_all(spread)
        splits = metric("partition_ops_total", op="split", result="committed")
        gw.until(lambda: metric("partition_ops_total", op="merge", result="committed") >= splits,
                 "the merge back to the boot geometry", 90)
        merged_s = time.perf_counter() - gw.t0
        verified = metric("partition_device_rebuilds_total", result="verified")
        mismatch = metric("partition_device_rebuilds_total", result="mismatch")
        check(verified >= 2 and mismatch == 0,
              f"11c: after the merge, device rebuilds verified {verified}, mismatch {mismatch}")
        state = gw.metric("device_state")
        check(state == {"": 0.0}, f"11c: device_state {state} after the merge")
        ops = gw.metric("partition_ops_total")
        migrations = gw.metric("balancer_migrations_total")
        stalls = metric("chaos_faults_total", point="device.dispatch_stall")
        gw.proc.send_signal(signal.SIGTERM)
        try:
            exit_code = gw.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"11c: the child did not exit within 30 s of SIGTERM: {gw.log()[-2000:]}")
        check(exit_code == 0, f"11c: the child exited {exit_code} on SIGTERM: {gw.log()[-2000:]}")
        print(f"11c elastic live: python -m channeld_tpu_torch on "
              f"{'cuda' if not dev_args else ' '.join(dev_args)} with {ELASTIC_CELLS_CONFIG}'s "
              f"world at MeshDevices {n_dev}, -partition (split {size['split']}, merge "
              f"{size['merge']}, depth 1) and -chaos (dispatch stalls: {stalls:g} fired): "
              f"{size['entities']} entities spawned and tracked at {spawned_s:.1f} s, herded into "
              f"one cell; split committed at {split_s:.1f} s, a balancer migration at "
              f"{migrated_s:.1f} s, dispersed, merged back at {merged_s:.1f} s; "
              f"partition_ops_total {ops}, balancer_migrations_total {migrations}, "
              f"partition_device_rebuilds_total verified {verified:g}, mismatch {mismatch:g}, "
              f"device_state 0; SIGTERM exit 0; phase {time.perf_counter() - t_phase:.1f} s")
        return dict(split_s=split_s, merged_s=merged_s)
    finally:
        gw.stop()
        shutil.rmtree(scratch, ignore_errors=True)


# ---- phase 12: the device-resident populations under churn and chaos --------
#
# The port's copies of scripts/sim_soak.py's and scripts/sensor_soak.py's
# worlds and schedules, with the soaks' own knobs and the device tables at
# the gateway's defaults (1<<17 entity slots, 4,096 query rows). 12a: the
# sim soak's phases with the -sim-agents default of 1,000 agents and 160
# tracked humans (about the soak's 96:16); 12b: the sensor soak's
# registrations x16 (4,096 entities; 768 follows, 768 clients, 384 sensors:
# 1,920 standing queries). ``--soaks AGENTS ENTITIES`` runs both alone.
SOAK_AGENTS, SOAK_ENTITIES = 1_000, 4_096
SIM_SOAK_SEED = 20260807  # scripts/sim_soak.py's
SENSOR_SOAK_SEED = 1919  # scripts/sensor_soak.py's
AGENT_BASE = 0x80000 + (1 << 22)  # entity_channel_id_start + the sim plane's AGENT_ID_OFFSET
HUMAN_BASE, SENSOR_ENTITY_BASE, FIRST_CLIENT = 0x90000, 0xA0000, 100
SUPERSET_CLIENTS = 8  # the sensor soak's superset check: its last 8 live clients


def soak_grid(cols: int, rows: int) -> dict:
    """The soaks' geometry: cols x rows cells of 100 m from the origin, one
    server, border 1."""
    return dict(WorldOffsetX=0, WorldOffsetZ=0, GridWidth=100, GridHeight=100, GridCols=cols,
                GridRows=rows, ServerCols=1, ServerRows=1, ServerInterestBorderSize=1)


def sim_soak_scenario(agents: int = SOAK_AGENTS, humans: Optional[int] = None,
                      ticks: tuple = (60, 50, 12, 12), census_every: int = 4,
                      slots: int = 1 << 17, queries: int = 4096) -> dict:
    """scripts/sim_soak.py's world and phases: 4x1 cells, the sim plane
    (max speed 20, step 0.25, p_wander 0.5, a census every
    ``census_every`` passes, seed 20260807), the guard with a 1 ms retry
    backoff; ``ticks`` ticks each of steady, stampede (``sim.stampede``
    once), guard (``sim.step_nan`` once) and epoch (a same-grid
    ``apply_grid`` first); the kill leg stops its child after 2 censuses.
    ``humans`` defaults to agents * 4 // 25."""
    seed = SIM_SOAK_SEED
    return dict(
        grid=soak_grid(4, 1), agents=agents, census_every=census_every, child_censuses=2,
        humans=agents * 4 // 25 if humans is None else humans,
        settings=dict(tpu_entity_capacity=slots, tpu_query_capacity=queries, sim_enabled=True,
                      sim_agents=agents, sim_seed=seed & 0xFFFFFFFF,
                      sim_census_every_ticks=census_every, sim_max_speed=20.0, sim_step_dt=0.25,
                      sim_p_wander=0.5, device_guard_enabled=True, device_retry_backoff_ms=1,
                      device_step_deadline_s=GATEWAY_DEADLINE_S),
        phases=(("steady", ticks[0], None),
                ("stampede", ticks[1], {"seed": seed, "faults": [
                    {"point": "sim.stampede", "every_n": 1, "max_fires": 1}]}),
                ("guard", ticks[2], {"seed": seed + 1, "faults": [
                    {"point": "sim.step_nan", "every_n": 1, "max_fires": 1}]}),
                ("epoch", ticks[3], None)))


def sensor_soak_scenario(entities: int = SOAK_ENTITIES, ticks: int = 90,
                         scale: Optional[int] = None, slots: int = 1 << 17,
                         queries: int = 4096) -> dict:
    """scripts/sensor_soak.py's world and schedule: 8x8 cells, the sim
    plane pinned off; ``entities`` tracked entities, a tenth moved each
    tick; 48, 48 and 24 x ``scale`` follows, clients (queries sent through
    the UpdateSpatialInterestMessage handler) and sensors (the first with
    a callback); ``scale`` clients close and as many arrive on ticks with
    t % 7 == 3, ``scale`` live clients re-issue a moved query on
    t % 11 == 5; a rebuild at ticks // 3 and a same-grid epoch at
    2 * ticks // 3. ``scale`` defaults to entities // 256 (the soak's own
    is 256 entities at scale 1)."""
    k = max(1, entities // 256) if scale is None else scale
    return dict(grid=soak_grid(8, 8), world=800.0, entities=entities, ticks=ticks,
                follows=48 * k, clients=48 * k, sensors=24 * k, churn=k,
                rebuild=ticks // 3, epoch=2 * ticks // 3,
                settings=dict(tpu_entity_capacity=slots, tpu_query_capacity=queries,
                              sim_enabled=False, device_step_deadline_s=GATEWAY_DEADLINE_S))


def host(x) -> np.ndarray:
    """A device array of either package as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def census_hash(eng) -> str:
    """scripts/sim_soak.py's census digest: rows sorted by agent id, every
    kinematic column of the host shadow, and the RNG cursor."""
    slots = eng.agent_slots()
    ids = np.asarray(eng.agent_ids(slots), np.uint32)
    order = np.argsort(ids, kind="stable")
    h = hashlib.sha256(ids[order].tobytes())
    for col, dtype in ((eng._positions, np.float32), (eng._vel, np.float32),
                       (eng._sim_state, np.int32), (eng._sim_target, np.float32)):
        h.update(np.asarray(col[slots], dtype)[order].tobytes())
    h.update(int(eng.sim_tick).to_bytes(8, "little"))
    return h.hexdigest()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


class SoakWorld:
    """A soak's world on one device, built and driven as scripts/sim_soak.py
    and scripts/sensor_soak.py build and drive theirs: the controller
    loaded from the soak's grid, one stub server subscribed to every cell,
    each tick the controller's ``tick`` and then every spatial channel's
    ``tick_once(0)``, on a fixed clock. ``P`` is the port's modules (or,
    in the tests, the JAX package's). Records each tick's handovers and
    engine ticks, the guarded step's and each guard rebuild's host time,
    and, with ``K`` on the card, each tick's kernel launches and device
    reads. ``checks`` collects the soak's invariants as (name, held,
    detail)."""

    def __init__(self, P, dev: torch.device, clock, scn: dict, K=None, wal_path: str = "",
                 restore: bool = False):
        self.P, self.dev, self.clock, self.scn, self.K = P, dev, clock, scn, K
        reset_gateway(P, keep_census=restore)
        P.tracing.recorder.enabled = False  # no anomaly dumps from the ladder's pins
        s = P.settings.global_settings
        s.development = True
        if P.port:
            s.spatial_device = dev.type
        for name, value in scn["settings"].items():
            setattr(s, name, value)
        P.message.init_message_map()
        P.channel.init_channels()
        P.sim_models.register_sim_types()
        if wal_path:
            s.wal_fsync_ms = 1.0
            P.wal.wal.start(wal_path)
        ctl = self.ctl = P.controller._controller_registry["TPUSpatialController"]()
        ctl.load_config(dict(scn["grid"]))
        P.controller.set_spatial_controller(ctl)
        self.eng = ctl.engine
        if P.port:
            check(self.eng.device.type == dev.type, f"the engine is on {self.eng.device}, not {dev}")
        server = GatewayConn(P, 1, "SERVER")
        self.conns = [server]
        ctx = P.message.MessageContext(msg_type=P.types.MessageType.CREATE_CHANNEL,
                                       msg=P.control_pb2.CreateChannelMessage(),
                                       connection=server)
        self.channels = ctl.create_channels(ctx)
        for ch in self.channels:
            P.sub.subscribe_to_channel(server, ch, None)
        self.handovers, self.step_ms, self.rebuild_ms, self.checks = [], [], [], []
        self.engine_ticks = 0
        self._wrap()

    def _wrap(self) -> None:
        guard, eng = self.P.guard, self.eng
        dispatch, body = guard.guard._dispatch, guard.DeviceGuard._rebuild_body
        handover_list, tick = eng.handover_list, eng.tick

        def timed_dispatch(engine):
            t0 = time.perf_counter()
            try:
                return dispatch(engine)
            finally:
                self.step_ms.append((time.perf_counter() - t0) * 1e3)

        def timed_body(*args):
            t0 = time.perf_counter()
            try:
                return body(*args)
            finally:
                self.rebuild_ms.append((time.perf_counter() - t0) * 1e3)

        def recorded_handovers(result):
            rows = handover_list(result)
            self.handovers.append(rows)
            return rows

        def counted_tick(*args, **kwargs):
            self.engine_ticks += 1
            return tick(*args, **kwargs)

        guard.guard._dispatch = timed_dispatch
        guard.DeviceGuard._rebuild_body = staticmethod(timed_body)
        eng.handover_list, eng.tick = recorded_handovers, counted_tick
        self._unwrap = lambda: (delattr(guard.guard, "_dispatch"),
                                setattr(guard.DeviceGuard, "_rebuild_body", staticmethod(body)))

    def expect(self, name: str, ok, detail="") -> None:
        self.checks.append((name, bool(ok), str(detail)[:300]))

    def drive(self, t: int) -> None:
        pass

    def observe(self) -> dict:
        return {}

    def report(self) -> dict:
        return {}

    def tick(self, t: int) -> dict:
        """One soak tick; returns what it produced (digests) and its costs."""
        P, eng, K = self.P, self.eng, self.K
        self.clock.advance(GATEWAY_TICK_S)
        self.drive(t)
        cuda = self.dev.type == "cuda"
        steps, crossings, ran = len(self.step_ms), len(self.handovers), self.engine_ticks
        before = K.launch_counts() if K is not None else None
        guard = P.guard.guard
        state, failures = guard.state.name, dict(guard.failure_counts)
        sync(self.dev)
        eng.last_result = None  # set again only by a step the guard serves
        with (Reads() if cuda else contextlib.nullcontext()) as reads:
            t0 = time.perf_counter()
            self.ctl.tick()
            for ch in self.channels:
                ch.tick_once(0)
            t1 = time.perf_counter()
        result = eng.last_result
        q = None
        if result is not None:
            count, rows = eng.query_changed_rows(result)
            q = (count, digest([rows[: min(count, len(rows))]])[0])
        tables = hashlib.sha256()
        for ch in self.channels:
            tables.update(ch.get_data_message().SerializeToString(deterministic=True))
        obs = dict(
            handovers=[r for rows in self.handovers[crossings:] for r in rows], q=q,
            tables=tables.hexdigest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns},
            guard=(guard.state.name, dict(guard.recovery_counts), dict(guard.failure_counts),
                   guard.held_ticks),
            served=result is not None, census=result is not None and "sim_census" in result,
            ran=self.engine_ticks - ran, tick_ms=(t1 - t0) * 1e3,
            step_ms=self.step_ms[steps] if len(self.step_ms) > steps else None,
            reads=reads.count if cuda else None, syncs=reads.syncs if cuda else None)
        obs["quiet"] = (obs["served"] and state == "ACTIVE" and guard.state.name == "ACTIVE"
                        and dict(guard.failure_counts) == failures)
        obs["steady"] = obs["quiet"] and not obs["census"]
        if K is not None:
            obs["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
        obs.update(self.observe())
        return obs

    def close(self) -> None:
        self.P.chaos.disarm()
        self._unwrap()
        reset_gateway(self.P)


class SimSoakWorld(SoakWorld):
    """12a: scripts/sim_soak.py's world: the sim plane's channel-backed
    population on 4x1 cells, driven through its four phases by ``run``
    (the tracked humans seeded first), each tick's sim columns digested
    (with ``columns``, their agent rows kept). On the card with ``K`` it
    keeps the live positions after the stampede (the population in one
    bin) and those the ``sim.step_nan`` rot left (NaN rows) for K1's
    checks at those shapes."""

    def __init__(self, P, dev, clock, scn: dict, K=None, wal_path: str = "",
                 restore: bool = False, columns: bool = False):
        super().__init__(P, dev, clock, scn, K, wal_path, restore)
        self.plane = self.ctl.simplane
        self.columns = [] if columns else None
        self.k1_inputs: dict = {}
        self.phase_ticks: dict = {}
        self.epoch_ms = self.stampede_handovers = None
        if K is not None:
            eng, corrupt = self.eng, self.eng.corrupt_sim_state_for_chaos

            def kept_corrupt():
                corrupt()
                self.k1_inputs["nan"] = (eng._d_positions.clone(), eng._d_valid.clone())

            eng.corrupt_sim_state_for_chaos = kept_corrupt

    def seed_humans(self) -> None:
        """scripts/sim_soak.py's human-driven entities sharing the world."""
        P, ctl = self.P, self.ctl
        rng = np.random.default_rng(SIM_SOAK_SEED)
        for i in range(self.scn["humans"]):
            x, z = float(rng.uniform(5, 395)), float(rng.uniform(5, 95))
            ctl.track_entity(HUMAN_BASE + i, P.controller.SpatialInfo(x, 0.0, z))

    def observe(self) -> dict:
        eng, plane = self.eng, self.plane
        cols = [host(c) for c in (eng._d_positions, eng._d_vel, eng._d_sim_state,
                                  eng._d_sim_target)]
        if self.columns is not None:
            slots = eng.agent_slots()
            self.columns.append([c[slots].copy() for c in cols])
        return dict(sim=digest(cols), ledgers=(dict(plane.ledgers), dict(plane.authority.ledgers),
                                               dict(eng.sim_rebuild_counts)))

    def report(self) -> dict:
        return dict(phase_ticks=dict(self.phase_ticks), agents=self.eng.agent_count(),
                    handovers=self.stampede_handovers,
                    recoveries=dict(self.P.guard.guard.recovery_counts),
                    rebuilds=dict(self.eng.sim_rebuild_counts), ledgers=dict(self.plane.ledgers))

    def exact_census(self, phase: str) -> None:
        """Every channel-backed agent in exactly one cell table; the device
        population equal to the authority's set."""
        eng, backed = self.eng, self.plane.authority._backed
        rows: dict[int, int] = {}
        for ch in self.channels:
            for eid in ch.get_data_message().entities:
                if eid >= AGENT_BASE:
                    rows[eid] = rows.get(eid, 0) + 1
        lost = [e for e in backed if rows.get(e, 0) == 0]
        duped = [e for e, n in rows.items() if n > 1]
        self.expect(f"{phase}: zero agents lost from cell tables", not lost, f"lost={lost[:5]}")
        self.expect(f"{phase}: zero agents duplicated in cell tables", not duped,
                    f"duped={duped[:5]}")
        self.expect(f"{phase}: device population intact", eng.agent_count() == len(backed),
                    f"device={eng.agent_count()} backed={len(backed)}")

    def run(self) -> list:
        """The soak's phases tick by tick with each phase's invariants and
        the exact census after each; returns every tick's observation."""
        P, ctl, eng, plane = self.P, self.ctl, self.eng, self.plane
        met, guard = P.metrics, P.guard.guard
        self.seed_humans()
        census0 = met.sim_census_transfers._value.get()
        rebuild0 = met.sim_device_rebuilds.labels(result="verified")._value.get()
        ledger0 = eng.sim_rebuild_counts.get("verified", 0)
        obs: list = []
        for name, n, chaos in self.scn["phases"]:
            ids = set(eng.agent_ids().tolist())
            h0 = met.handover_count._value.get()
            r0 = guard.recovery_counts.get("corruption", 0)
            if name == "epoch":
                t0 = time.perf_counter()
                eng.apply_grid(eng.grid, ctl.rebuild_seed_cells())
                errors = eng.verify_device_state(ctl.rebuild_seed_cells())
                self.epoch_ms = (time.perf_counter() - t0) * 1e3
                self.expect("epoch: verify clean after re-home", not errors, errors)
                self.expect("epoch: population ids exact across epoch",
                            set(eng.agent_ids().tolist()) == ids, "id set changed")
            if chaos:
                P.chaos.arm(chaos)
            self.phase_ticks[name] = (len(obs), len(obs) + n)
            for _ in range(n):
                obs.append(self.tick(len(obs)))
            if chaos:
                P.chaos.disarm()
            led = dict(plane.ledgers)
            if name == "steady":
                self.expect("steady: sim passes ran", led.get("sim_passes", 0) >= n, led)
                self.expect("steady: censuses flowed", led.get("census_transfers", 0) >= 2, led)
                self.expect("steady: censuses journaled to WAL",
                            led.get("censuses_journaled", 0) >= 2, led)
                self.expect("steady: authority commits flowed",
                            plane.authority.ledgers.get("commits", 0) >= 2,
                            plane.authority.ledgers)
                self.expect("steady: census transfer double-entry",
                            met.sim_census_transfers._value.get() - census0
                            == led.get("census_transfers", 0),
                            f"metric {met.sim_census_transfers._value.get()} baseline {census0}")
            elif name == "stampede":
                handovers = met.handover_count._value.get() - h0
                self.stampede_handovers = int(handovers)
                self.expect("stampede: chaos point fired", led.get("chaos_stampede", 0) == 1, led)
                self.expect("stampede: crossings flowed through ordinary handover",
                            handovers > 0, f"handovers={handovers}")
                if self.K is not None:
                    self.k1_inputs["one_bin"] = (eng._d_positions.clone(), eng._d_valid.clone())
            elif name == "guard":
                self.expect("guard: corruption sentinel recovered",
                            guard.recovery_counts.get("corruption", 0) == r0 + 1,
                            guard.recovery_counts)
                self.expect("guard: device ACTIVE after rebuild", guard.state.name == "ACTIVE",
                            guard.state)
                self.expect("guard: population ids exact across rebuild",
                            set(eng.agent_ids().tolist()) == ids, "id set changed")
                pos = host(eng._d_positions)[eng.agent_slots()]
                self.expect("guard: device positions finite", np.isfinite(pos).all(),
                            "NaN survived rebuild")
                self.expect("guard: sim rebuild double-entry",
                            eng.sim_rebuild_counts.get("verified", 0) - ledger0
                            == met.sim_device_rebuilds.labels(result="verified")._value.get()
                            - rebuild0, eng.sim_rebuild_counts)
            self.exact_census(name)
        return obs


class SensorSoakWorld(SoakWorld):
    """12b: scripts/sensor_soak.py's world: tracked entities on 8x8 cells
    and the three scopes of standing queries (follows, clients through
    the interest handler, sensors), churned on the soak's schedule;
    ``books`` checks its accounting after the run. Each tick's query pass
    (``queryplane.pump``) is timed on the host's clock."""

    def __init__(self, P, dev, clock, scn: dict, K=None):
        super().__init__(P, dev, clock, scn, K)
        P, ctl = self.P, self.ctl
        ops = P.ops
        self.plane = ctl.queryplane
        self.rng = np.random.default_rng(SENSOR_SOAK_SEED)
        self.eids = []
        for i in range(scn["entities"]):
            x, z = self.rand_xz()
            ctl.track_entity(SENSOR_ENTITY_BASE + i, P.controller.SpatialInfo(x, 0.0, z))
            self.eids.append(SENSOR_ENTITY_BASE + i)
        self.next_cid = FIRST_CLIENT
        for i in range(scn["follows"]):
            ctl.register_follow_interest(self.new_conn(), self.eids[i % len(self.eids)],
                                         ops.AOI_SPHERE, extent=(150.0, 0.0))
        self.clients = []
        for _ in range(scn["clients"]):
            conn = self.new_conn()
            self.send_query(conn, *self.rand_xz())
            self.clients.append(conn)
        self.callback_hits = []
        world = scn["world"]
        ctl.register_sensor("cb", kind=ops.AOI_SPHERE, center=(world / 2, world / 2),
                            extent=(200.0, 0.0),
                            callback=lambda key, cells: self.callback_hits.append(len(cells)))
        for i in range(scn["sensors"] - 1):
            ctl.register_sensor(f"s{i}", kind=ops.AOI_BOX if i % 2 else ops.AOI_SPHERE,
                                center=self.rand_xz(), extent=(90.0, 140.0))
        self.closed, self.pass_ms, self.epoch_ms = 0, [], None
        pump = self.plane.pump

        def timed_pump(result, apply=True):
            t0 = time.perf_counter()
            try:
                return pump(result, apply)
            finally:
                self.pass_ms.append((time.perf_counter() - t0) * 1e3)

        self.plane.pump = timed_pump
        # The books' baselines: after registration, before the measured window.
        self.base = P.invariants.scrape()
        self.ledgers0 = dict(self.plane.ledgers)

    def rand_xz(self) -> tuple:
        w = self.scn["world"]
        return float(self.rng.uniform(0, w)), float(self.rng.uniform(0, w))

    def new_conn(self) -> GatewayConn:
        conn = GatewayConn(self.P, self.next_cid, "CLIENT")
        self.next_cid += 1
        self.P.connection._all_connections[conn.id] = conn
        self.conns.append(conn)
        return conn

    def send_query(self, conn, x: float, z: float, r: float = 120.0) -> None:
        P = self.P
        msg = P.spatial_pb2.UpdateSpatialInterestMessage(connId=conn.id)
        msg.query.sphereAOI.center.x, msg.query.sphereAOI.center.z = x, z
        msg.query.sphereAOI.radius = r
        P.spatial_messages.handle_update_spatial_interest(P.message.MessageContext(
            msg_type=P.types.MessageType.UPDATE_SPATIAL_INTEREST, msg=msg, connection=conn))

    def drive(self, t: int) -> None:
        scn, ctl, eng = self.scn, self.ctl, self.eng
        SpatialInfo = self.P.controller.SpatialInfo
        for eid in self.rng.choice(self.eids, max(1, len(self.eids) // 10), replace=False).tolist():
            x, z = self.rand_xz()
            ctl.track_entity(eid, SpatialInfo(x, 0.0, z))
        if t % 7 == 3:
            for _ in range(min(scn["churn"], len(self.clients))):
                gone = self.clients.pop(0)
                gone.close()
                self.closed += 1
                conn = self.new_conn()
                self.send_query(conn, *self.rand_xz())
                self.clients.append(conn)
        if t % 11 == 5:
            for conn in self.clients[-scn["churn"]:]:
                self.send_query(conn, *self.rand_xz())
        if t in (scn["rebuild"], scn["epoch"]):
            sync(self.dev)
            t0 = time.perf_counter()
            if t == scn["rebuild"]:
                eng.rebuild_device_state(ctl.rebuild_seed_cells())
            else:
                eng.apply_grid(eng.grid, ctl.rebuild_seed_cells())
            sync(self.dev)
            ms = (time.perf_counter() - t0) * 1e3
            if t == scn["rebuild"]:
                self.rebuild_ms.append(ms)
            else:
                self.epoch_ms = ms

    def report(self) -> dict:
        return dict(closed=self.closed, standing=self.plane.count(),
                    callbacks=len(self.callback_hits), ledgers=dict(self.plane.ledgers),
                    pass_ms=list(self.pass_ms), clients=len(self.clients))

    def observe(self) -> dict:
        subs = [(c.id, sorted(c.spatial_subscriptions)) for c in self.conns[1:]]
        return dict(ledgers=dict(self.plane.ledgers), subs=digest([np.array(
            [v for cid, chs in subs for v in (cid, len(chs), *chs)], np.int64)])[0],
            callbacks=len(self.callback_hits), standing=self.plane.count())

    def superset(self, conns) -> list:
        """The clients among ``conns`` whose host answer
        (``query_channel_ids`` of their standing query) is not a subset of
        their device-driven subscriptions."""
        bad = []
        for conn in conns:
            entry = self.plane._entries.get(conn.id)
            if entry is None:
                bad.append((conn.id, "no standing row"))
                continue
            q = self.P.spatial_pb2.SpatialInterestQuery()
            q.sphereAOI.center.x, q.sphereAOI.center.z = entry["center"]
            q.sphereAOI.radius = entry["extent"][0]
            missing = set(self.ctl.query_channel_ids(q)) - set(conn.spatial_subscriptions)
            if missing:
                bad.append((conn.id, sorted(missing)[:4]))
        return bad

    def books(self, ticks: int, every_client: bool) -> None:
        """The sensor soak's invariants over the ``ticks`` ticks run; the
        superset check over its last 8 live clients and, with
        ``every_client``, over every live one."""
        inv, plane = self.P.invariants, self.plane
        d = inv.delta(inv.scrape(), self.base)
        led = {k: plane.ledgers[k] - self.ledgers0.get(k, 0) for k in plane.ledgers}
        self.expect("one_transfer_per_tick", led["transfers"] == ticks, led)
        self.expect("transfers_ledger_matches_metric",
                    led["transfers"] == inv.sample_total(d, "query_plane_transfers_total"), led)
        self.expect("rows_changed_ledger_matches_metric",
                    led["rows_changed"] == inv.sample_total(d, "query_rows_changed_total"), led)
        self.expect("full_resyncs_ledger_matches_metric",
                    led["full_resyncs"] == inv.sample_total(d, "query_full_resyncs_total"), led)
        self.expect("rebuild_and_epoch_each_full_resynced", led["full_resyncs"] == 2, led)
        self.expect("pass_timed_every_tick",
                    inv.sample_total(d, "query_pass_ms_count") == ticks,
                    inv.sample_total(d, "query_pass_ms_count"))
        self.expect("churned_rows_reaped", plane.ledgers["reaped"] == self.closed,
                    (plane.ledgers["reaped"], self.closed))
        scopes = {"follow": 0, "client": 0, "sensor": 0}
        for e in plane._entries.values():
            scopes[e["scope"]] += 1
        live = inv.scrape()
        for scope, n in scopes.items():
            got = inv.sample_total(live, "standing_queries", scope=scope)
            self.expect(f"standing_queries_gauge_matches_registry_{scope}", got == n, (got, n))
        self.expect("sensor_callback_fired", len(self.callback_hits) > 0, len(self.callback_hits))
        self.expect("rows_flowed", led["rows_changed"] > 0, led)
        bad = self.superset(self.clients[-SUPERSET_CLIENTS:])
        self.expect("client_query_subs_superset_of_host", not bad, bad)
        if every_client:
            bad = self.superset(self.clients)
            self.expect("every_live_client_subs_superset_of_host", not bad, bad[:4])
        conns = self.P.connection._all_connections
        held = [k for k in range(FIRST_CLIENT, self.next_cid)
                if (c := conns.get(k)) is not None and c.is_closing() and k in plane._entries]
        self.expect("closed_clients_hold_no_rows", not held, held[:5])


def run_soak_leg(K, leg: str, leg_dev, make_world, run) -> tuple:
    """One leg of a soak in a fresh gateway on a fixed clock: (observations,
    report), the report holding ``run``'s result and the world's checks,
    timings and counts (and on the card its launches)."""
    t_leg = time.perf_counter()
    with FixedClock() as clock:
        world = make_world(leg, leg_dev, clock)
        if leg == "cuda":
            K.reset_launch_counts()
        obs = run(world)
        r = dict(checks=list(world.checks), engine_ticks=world.engine_ticks,
                 step_ms=list(world.step_ms), rebuild_ms=list(world.rebuild_ms),
                 epoch_ms=world.epoch_ms, world=world.report())
        if leg == "cuda":
            r["launches"] = K.launch_counts()
        world.close()
        del world
    r["secs"] = time.perf_counter() - t_leg
    return obs, r


def run_soak_legs(K, dev, make_world, run) -> tuple:
    """One soak on the card (counted launches) and then on the CPU; returns
    ({leg: observations}, {leg: report})."""
    legs, report = {}, {}
    for leg, leg_dev in (("cuda", dev), ("cpu", torch.device("cpu"))):
        legs[leg], report[leg] = run_soak_leg(K, leg, leg_dev, make_world, run)
    return legs, report


def check_soak_legs(K, label: str, legs: dict, report: dict, census_extra: int) -> list:
    """Card equal to CPU on every tick; every invariant held on both legs;
    each kernel launched once on every tick the engine ran and never
    otherwise (once per engine tick in all); 2 reads per steady tick and
    ``census_extra`` more on a census tick. Returns the census ticks."""
    card, cpu = legs["cuda"], legs["cpu"]
    check(len(card) == len(cpu), f"{label}: {len(card)} card ticks, {len(cpu)} cpu ticks")
    for t in range(len(card)):
        where = first_gateway_diff(card[t], cpu[t])
        if where is not None:
            print(f"MISMATCH {label} tick {t}: {where}")
        check(where is None, f"{label} tick {t}: cuda and cpu differ: {where}")
    for leg in ("cuda", "cpu"):
        failed = [c for c in report[leg]["checks"] if not c[1]]
        for name, _, detail in failed:
            print(f"INVARIANT FAILED {label} {leg}: {name}: {detail}")
        check(not failed, f"{label} {leg}: {len(failed)} invariants failed, first "
                          f"{failed[:1]}")
    r = report["cuda"]
    for t, o in enumerate(card):
        want = {name: o["ran"] for name in o["launches"]}
        check(o["launches"] == want and o["ran"] <= 1,
              f"{label} tick {t}: launches {o['launches']} with {o['ran']} engine ticks")
    for name, count in r["launches"].items():
        check(count == r["engine_ticks"] > 0, f"{label}: kernel {name} launched {count} times in "
                                              f"{r['engine_ticks']} engine ticks")
    census = [t for t, o in enumerate(card) if o["census"]]
    steady = [t for t, o in enumerate(card) if t and o["steady"]]
    reads = sorted({card[t]["reads"] for t in steady})
    check(reads == [2], f"{label}: device reads per steady tick {reads}, not 2")
    if census_extra:
        extra = sorted({card[t]["reads"] - 2 for t in census if card[t]["quiet"]})
        check(extra == [census_extra], f"{label}: census ticks read {extra} more than a steady "
                                       f"tick, not {census_extra}")
    return census


def soak_live_kernels(K, grid, pos, valid, qs) -> dict:
    """K1 (and, given the query rows ``qs``, K2) against the plain version
    on a soak's live tensors, exact, with each alone (bare launches,
    events), its plain version and its bound. Uncounted."""
    def measure():
        n, c = pos.shape[0], grid.num_cells
        err1 = max_abs_diff(zip(K.assign_and_count(grid, pos, valid),
                                K.assign_and_count_plain(grid, pos, valid)))
        check(err1 == 0, f"K1 on the soak's live tensors ({n} x {c}): |diff| {err1}")
        counts = K.assign_and_count_plain(grid, pos, valid)[1]
        b1, by1 = bound_ms(pos.numel() * 4 + n + 4 * n + 4 * c, ASSIGN_OPS_PER_SLOT * n)
        out = {"assign_count": dict(
            shape=f"{n} slots x {c} bins", max_abs_err=err1, bound_ms=b1, bound_by=by1,
            placed=int(counts.sum()), top_bin=int(counts.max()),
            nan_rows=int(torch.isnan(pos[:, 0]).sum()),
            ms=queued_ms(K.prepare_assign_count(grid, pos, valid).run),
            plain_ms=median_ms(lambda: K.assign_and_count_plain(grid, pos, valid), reps=20,
                               warmup=2), library_ms=None)}
        if qs is not None:
            args = (qs.kind, qs.center, qs.extent, qs.direction, torch.cos(qs.angle))
            err2 = max_abs_diff(zip(K.aoi_tile(grid, *args), K.aoi_tile_plain(grid, *args)))
            check(err2 == 0, f"K2 on the soak's live query rows: |diff| {err2}")
            q = args[0].shape[0]
            b2, by2 = bound_ms(q * (4 + 3 * 8 + 4) + q * c * 5,
                               AOI_OPS_PER_PAIR * q * c
                               + AOI_OPS_PER_AXIS * q * (grid.cols + grid.rows))
            out["aoi"] = dict(
                shape=f"{q} x {c} pairs", max_abs_err=err2, bound_ms=b2, bound_by=by2,
                live_rows=int((qs.kind != 0).sum()),
                ms=queued_ms(K.prepare_aoi(grid, *args, 0, c).run),
                plain_ms=median_ms(lambda: K.aoi_tile_plain(grid, *args), reps=20, warmup=2),
                library_ms=None)
        return out

    return uncounted(K, measure)


def sim_soak_replay(P, dev: torch.device, scn: dict, wal_path: str, last: dict) -> dict:
    """A restarted gateway on ``dev``: a fresh runtime replays the child's
    WAL at boot and the sim plane takes the staged census at activation
    (scripts/sim_soak.py's kill9_phase); the restored population must
    hash as the child's last journaled census, then keep stepping."""
    reset_gateway(P)
    P.message.init_message_map()
    P.channel.init_channels()
    P.sim_models.register_sim_types()
    t0 = time.perf_counter()
    rep = P.wal.boot_replay("", wal_path)
    replay_s = time.perf_counter() - t0
    replayed = dict(P.wal.wal.replay_counts)
    n, tick = int(last["n"]), int(last["tick"])
    with FixedClock() as clock:
        t0 = time.perf_counter()
        world = SimSoakWorld(P, dev, clock, scn, restore=True)
        boot_s = time.perf_counter() - t0
        eng = world.eng
        restored = census_hash(eng)
        world.expect("kill9: WAL replay clean", rep["wal_records"] > 0 and not rep["torn"], rep)
        world.expect("kill9: restored census bit-identical to last journaled",
                     restored == last["hash"], f"restored {restored[:16]} journaled "
                                               f"{last['hash'][:16]}")
        world.expect("kill9: population count exact", eng.agent_count() == n,
                     f"{eng.agent_count()} != {n}")
        world.expect("kill9: sim clock resumed", eng.sim_tick == tick, f"{eng.sim_tick} != {tick}")
        world.expect("kill9: replay counter double-entry", replayed.get("sim_census", 0) == n,
                     replayed)
        for t in range(scn["census_every"] + 1):
            world.tick(t)
        world.expect("kill9: restored world keeps stepping", eng.sim_tick > tick, eng.sim_tick)
        world.exact_census("kill9")
        checks = list(world.checks)
        world.close()
    failed = [c for c in checks if not c[1]]
    check(not failed, f"12a kill leg on {dev.type}: {failed}")
    return dict(hash=restored, replay_s=replay_s, boot_s=boot_s, records=rep["wal_records"])


def sim_soak_kill(scn: dict, scratch: str, dev: torch.device) -> dict:
    """12a's kill leg: ``--sim-child`` on ``dev`` (the card) journals
    censuses to a WAL and is SIGKILLed after ``child_censuses`` of them;
    the WAL is then replayed on ``dev`` and on the CPU."""
    import os
    import queue
    import signal
    import threading

    wal_path, log_path = f"{scratch}/child.wal", f"{scratch}/child.log"
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-u", os.path.join(here, "chip_smoke.py"), "--sim-child", wal_path,
           str(scn["agents"]), str(scn["census_every"]), dev.type]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        child = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE, stderr=log, text=True)
    lines: queue.Queue = queue.Queue()

    def read_lines():
        for ln in child.stdout:
            lines.put(ln)
        lines.put("")  # end of its output

    threading.Thread(target=read_lines, daemon=True).start()
    censuses, ready_s = [], None
    try:
        while len(censuses) < scn["child_censuses"]:
            try:
                line = lines.get(timeout=max(1.0, 300.0 - (time.perf_counter() - t0)))
            except queue.Empty:
                line = None
            if not line:
                with open(log_path) as f:
                    tail = f.read()[-2000:]
                check(False, f"12a child: {len(censuses)} censuses before it "
                             f"{'died' if line == '' else 'timed out'} (exit {child.poll()}); "
                             f"its log ends: {tail}")
            if line.startswith("READY"):
                ready_s = time.perf_counter() - t0
            elif line.startswith("CENSUS "):
                censuses.append(dict(kv.split("=") for kv in line.split()[1:]))
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait()
    killed_s = time.perf_counter() - t0
    last = censuses[-1]
    P = gateway_modules()
    restored = {leg: sim_soak_replay(P, d, scn, wal_path, last)
                for leg, d in (("cuda", dev), ("cpu", torch.device("cpu")))}
    return dict(ready_s=ready_s, killed_s=killed_s, censuses=censuses, restored=restored,
                wal_bytes=os.path.getsize(wal_path))


def sim_child(wal_path: str, agents: int = SOAK_AGENTS, census_every: int = 4,
              device: str = "cuda") -> int:
    """``--sim-child WAL [AGENTS CENSUS_EVERY [DEVICE]]``: 12a's world
    (without its humans, as scripts/sim_soak.py's child) on the card,
    journaling to ``WAL`` until it is SIGKILLed; prints ``READY`` once
    built and one ``CENSUS tick= n= hash=`` line per journaled census."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    P = gateway_modules()
    scn = sim_soak_scenario(agents, census_every=census_every)
    world = SimSoakWorld(P, dev, WallClock(), scn, wal_path=wal_path)
    eng, plane = world.eng, world.plane
    print("READY", flush=True)
    last = 0
    for t in range(1_000_000):
        world.tick(t)
        journaled = plane.ledgers.get("censuses_journaled", 0)
        if journaled > last:
            last = journaled
            P.wal.wal.flush()
            print(f"CENSUS tick={eng.sim_tick} n={eng.agent_count()} hash={census_hash(eng)}",
                  flush=True)
    return 1


def phase_sim_soak(K, dev, scn: dict) -> tuple:
    """12a: the port's copy of scripts/sim_soak.py through the port's
    controller on the card and on the CPU, tick for tick, each leg held to
    every invariant of the soak; then the kill leg. Returns (K1/K2
    launches on this path, the kernels' entries at its shapes)."""
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="sim-soak-")
    t_phase = time.perf_counter()
    entries: dict = {}

    def make(leg, leg_dev, clock):
        return SimSoakWorld(P, leg_dev, clock, scn, K=K if leg == "cuda" else None,
                            wal_path=f"{scratch}/{leg}.wal")

    def run(world):
        obs = world.run()
        if world.K is not None:
            eng = world.eng
            for case, (pos, valid) in world.k1_inputs.items():
                entries[case] = soak_live_kernels(K, eng.grid, pos, valid, None)
            entries["queries"] = soak_live_kernels(K, eng.grid, eng._d_positions, eng._d_valid,
                                                   eng._d_queries)
        return obs

    try:
        legs, report = run_soak_legs(K, dev, make, run)
        census = check_soak_legs(K, "12a", legs, report, census_extra=4)
        kill = sim_soak_kill(scn, scratch, dev)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    card, r = legs["cuda"], report["cuda"]
    w = r["world"]
    check(set(entries) == {"one_bin", "nan", "queries"}, f"12a kernel cases {sorted(entries)}")
    nan_tick = next(t for t, o in enumerate(card) if o["guard"][1].get("corruption"))
    for leg in ("cuda", "cpu"):
        restored = kill["restored"][leg]["hash"]
        check(restored == kill["censuses"][-1]["hash"], f"12a kill leg: {leg} restored {restored}")
    print(f"12a sim soak: {len(card)} ticks (steady, stampede, guard, epoch at "
          f"{ {k: v[0] for k, v in w['phase_ticks'].items()} }) of {w['agents']} agents and "
          f"{scn['humans']} tracked humans on 4x1 cells ({scn['settings']['tpu_entity_capacity']} "
          f"slots, {scn['settings']['tpu_query_capacity']} query rows) on cuda equal the CPU leg "
          f"on every tick: handovers ({sum(len(o['handovers']) for o in card)}; the stampede's "
          f"{w['handovers']}), cell tables, the server's stream, sim columns bit for bit, the "
          f"guard, the plane's, authority's and rebuild ledgers; every invariant of the soak on "
          f"both legs ({len(r['checks'])} checks); sim.step_nan's corruption caught on tick "
          f"{nan_tick} on both legs, recoveries {w['recoveries']}, sim rebuilds {w['rebuilds']}; "
          f"census ticks {len(census)}, reads per steady tick 2 and +4 on a census tick; "
          f"launches {r['launches']} in {r['engine_ticks']} engine ticks of {len(card)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s (card leg {r['secs']:.1f} s, cpu leg "
          f"{report['cpu']['secs']:.1f} s)")
    for leg in ("cuda", "cpu"):
        obs, rr = legs[leg], report[leg]
        ph = rr["world"]["phase_ticks"]
        print(f"12a on {leg}: tick median/p99 " + "; ".join(
            f"{name} {tick_stats([obs[t]['tick_ms'] for t in range(a, b)])}"
            for name, (a, b) in ph.items())
              + f"; guarded step {tick_stats(rr['step_ms'])}; rebuild + verify after "
              f"sim.step_nan " + ", ".join(f"{ms:.3f}" for ms in rr["rebuild_ms"])
              + f" ms; same-grid apply_grid + verify {rr['epoch_ms']:.3f} ms")
    print(f"12a kill leg: the child (--sim-child, cuda) ready after {kill['ready_s']:.1f} s, "
          f"SIGKILLed after {len(kill['censuses'])} censuses at {kill['killed_s']:.1f} s (last "
          f"census sim tick {kill['censuses'][-1]['tick']}, {kill['censuses'][-1]['n']} agents, "
          f"hash {kill['censuses'][-1]['hash'][:16]}); its WAL ({kill['wal_bytes']} bytes) "
          f"replayed on " + "; ".join(
              f"{leg}: {x['records']} records in {x['replay_s']:.3f} s, world up in "
              f"{x['boot_s']:.3f} s, census restored bit for bit"
              for leg, x in kill["restored"].items()))
    for case, e in entries.items():
        for name, k in e.items():
            print(f"12a {name} on the live tensors ({case}: {k['shape']}"
                  + (f", {k['placed']} placed, {k['top_bin']} in the fullest bin, "
                     f"{k['nan_rows']} NaN rows" if name == "assign_count" else
                     f", {k['live_rows']} live rows")
                  + f"): exact; alone {k['ms']:.4f} ms (events, bare launches), plain "
                  f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']})")
    return r["launches"], entries


def sensor_soak_run(K, scn: dict, entries: dict):
    """12b's drive of one leg's world: every tick, the soak's books, and on
    the card the kernels on the live tensors (into ``entries``)."""
    def run(world):
        obs = [world.tick(t) for t in range(scn["ticks"])]
        world.books(scn["ticks"], every_client=True)
        if world.K is not None:
            eng = world.eng
            entries["queries"] = soak_live_kernels(K, eng.grid, eng._d_positions, eng._d_valid,
                                                   eng._d_queries)
        return obs

    return run


def phase_sensor_soak(K, dev, cpu_leg: "CpuLeg") -> tuple:
    """12b: the port's copy of scripts/sensor_soak.py (the scenario
    ``cpu_leg.size``) through the port's controller on the card and on the
    CPU in ``cpu_leg``'s child, tick for tick, each leg held to every book
    of the soak. Returns (K1/K2 launches on this path, the kernels' entries
    at its shapes)."""
    P = gateway_modules()
    scn = cpu_leg.size
    t_phase = time.perf_counter()
    entries: dict = {}
    legs, report = {}, {}
    try:
        legs["cuda"], report["cuda"] = run_soak_leg(
            K, "cuda", dev, lambda leg, leg_dev, clock: SensorSoakWorld(P, leg_dev, clock, scn, K=K),
            sensor_soak_run(K, scn, entries))
        legs["cpu"], report["cpu"] = cpu_leg.result()
    finally:
        cpu_leg.close()
    check_soak_legs(K, "12b", legs, report, census_extra=0)
    card, r = legs["cuda"], report["cuda"]
    w = r["world"]
    print(f"12b sensor soak: {scn['ticks']} ticks of {scn['entities']} tracked entities (a "
          f"tenth moved a tick) on 8x8 cells with {scn['follows']} follows, {scn['clients']} "
          f"clients and {scn['sensors']} sensors ({w['standing']} standing queries at the end; "
          f"{w['closed']} clients closed and as many arrived; rebuild at {scn['rebuild']}, "
          f"same-grid epoch at {scn['epoch']}) on cuda equal the CPU leg on every tick: changed "
          f"query rows, the plane's ledgers, every connection's stream and subscriptions, the "
          f"callback; the soak's books on both legs ({len(r['checks'])} checks, the superset "
          f"over every live client among them); ledgers {w['ledgers']}; reads per steady tick "
          f"2; launches {r['launches']} in {r['engine_ticks']} engine ticks; phase "
          f"{time.perf_counter() - t_phase:.1f} s (card leg {r['secs']:.1f} s, cpu leg "
          f"{report['cpu']['secs']:.1f} s in a --cpu-leg child)")
    for leg in ("cuda", "cpu"):
        obs, rr = legs[leg], report[leg]
        print(f"12b on {leg}: tick {tick_stats([o['tick_ms'] for o in obs])}; guarded step "
              f"{tick_stats(rr['step_ms'])}; query pass (queryplane.pump) "
              f"{tick_stats(rr['world']['pass_ms'])}; rebuild {rr['rebuild_ms'][0]:.3f} ms; "
              f"same-grid apply_grid {rr['epoch_ms']:.3f} ms")
    for name, k in entries["queries"].items():
        print(f"12b {name} on the live tensors ({k['shape']}): exact; alone {k['ms']:.4f} ms "
              f"(events, bare launches), plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']})")
    return r["launches"], entries


def phase_soaks(K, dev, sensor_cpu_leg: "CpuLeg", agents: int = SOAK_AGENTS) -> tuple:
    """12a and 12b (12b's CPU leg in ``sensor_cpu_leg``'s child). Returns
    ({path: launches}, {path: kernel entries})."""
    sim_launches, sim_entries = phase_sim_soak(K, dev, sim_soak_scenario(agents))
    sensor_launches, sensor_entries = phase_sensor_soak(K, dev, sensor_cpu_leg)
    return ({"sim_soak": sim_launches, "sensor_soak": sensor_launches},
            {"sim_soak": sim_entries, "sensor_soak": sensor_entries})


# ---- phase 13: the trace and obs planes ----------------------------------------

TRACE_SOAK_SEED = 20260803  # scripts/trace_soak.py's
OBS_SOAK_SEED = 20260804  # scripts/obs_soak.py's
TRACE_STAGES = ("ingest", "messages", "fanout", "device_step", "readback", "follow_interests",
                "handover", "overload")
TRACE_CELLS_CONFIG = "config/spatial_tpu_cells_2x2.json"
SOAK_TABLES = dict(tpu_entity_capacity=256, tpu_query_capacity=32)  # both soaks' live phase
OVERHEAD_TABLES = dict(tpu_entity_capacity=256, tpu_query_capacity=16)  # their phase 3
DEFAULT_TABLES = dict(tpu_entity_capacity=1 << 17, tpu_query_capacity=4096)  # the gateway's


def trace_scenario(tick_budget_every: int = 300, dispatch_every: int = 200) -> dict:
    """scripts/trace_soak.py's chaos scenario (seed 20260803): 60 ms stalls in
    a message handler (a blown tick budget) and 40 ms device-dispatch
    stalls; ``*_every`` are the rules' ``every_n``."""
    return {"name": "trace-soak", "seed": TRACE_SOAK_SEED, "faults": [
        {"point": "channel.tick_budget", "every_n": tick_budget_every, "stall_ms": 60,
         "max_fires": 6},
        {"point": "device.dispatch_stall", "every_n": dispatch_every, "stall_ms": 40,
         "max_fires": 8}]}


def obs_scenario() -> dict:
    """scripts/obs_soak.py's chaos scenario (seed 20260804): 60 ms stalls in
    message handling every 25th call, the breach window's weather."""
    return {"name": "obs-soak", "seed": OBS_SOAK_SEED, "faults": [
        {"point": "channel.tick_budget", "every_n": 25, "stall_ms": 60, "max_fires": 60}]}


def trace_params(**kw) -> dict:
    """scripts/trace_soak.py's TraceSoakParams for its phases 1 and 3."""
    return dict(dict(live_s=20.0, clients=16, msg_rate=30.0, entities=120, followers=8,
                     storm_size=40, quiesce_s=3.0, overhead_ticks=120, overhead_rounds=3,
                     seed=TRACE_SOAK_SEED, scenario=trace_scenario()), **kw)


def obs_params(**kw) -> dict:
    """scripts/obs_soak.py's ObsSoakParams for its phases 1 and 3."""
    return dict(dict(steady_s=15.0, breach_s=12.0, clients=8, msg_rate=20.0, viewers=4,
                     update_rate=40.0, entities=48, warmup_s=6.0, quiesce_s=2.0,
                     overhead_ticks=120, overhead_rounds=3, seed=OBS_SOAK_SEED,
                     scenario=obs_scenario()), **kw)


def trace_lockstep_scenario(ticks: int = 150, entities: int = 120,
                            followers: int = 8, clients: int = 16, storm: int = 40,
                            tables: dict = DEFAULT_TABLES) -> dict:
    """13a: the trace soak's live world on a fixed clock. Each tick every
    client sends one forward (30 msg/s is about one a 33 ms tick) and an
    eighth of the entities take a jitter step; the storm gathers at 30% of
    the run and disperses at 70%. The chaos rules keep the soak's stalls
    with ``every_n`` scaled to this run's calls (one ``channel.tick_budget``
    call per handled message, one ``device.dispatch_stall`` call per
    controller tick), so each can fire 4 times."""
    calls = ticks * (max(1, entities // 8) + clients)
    return dict(ticks=ticks, entities=entities, followers=followers, clients=clients,
                storm=storm, storm_at=int(ticks * 0.3), disperse_at=int(ticks * 0.7),
                tables=dict(tables), seed=TRACE_SOAK_SEED,
                chaos=trace_scenario(min(300, max(1, calls // 4)), min(200, max(1, ticks // 4))))


def cells_config(n_dev: int, scratch: str, overrides: Optional[dict] = None) -> str:
    """A copy of config/spatial_tpu_cells_2x2.json with MeshDevices = n_dev
    (the cards present bound it: F10) and a scenario's ``config_overrides``."""
    import os

    with open(TRACE_CELLS_CONFIG) as f:
        cfg = json.load(f)
    cfg["Config"]["MeshDevices"] = n_dev
    cfg["Config"].update(overrides or {})
    path = os.path.join(scratch, "spatial_tpu_cells_2x2.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def soak_pins(P, dev, tables: dict, subworld: Optional[tuple] = None) -> None:
    """Both soaks' pins: the balancer, partitioning, the ladder, the query
    plane and the sim plane off, no federation; channel intervals GLOBAL
    33/50 ms, SPATIAL and ENTITY 50/100 ms (tick / fan-out), SUBWORLD
    ``subworld``; the device tables ``tables``; the engine on ``dev``."""
    s = P.settings.global_settings
    s.development = True
    if P.port:
        s.spatial_device = dev.type
    s.balancer_enabled = s.partition_enabled = False
    s.overload_enabled = s.queryplane_enabled = s.sim_enabled = False
    s.federation_config = ""
    for name, value in tables.items():
        setattr(s, name, value)
    cs, ct = P.settings.ChannelSettings, P.types.ChannelType
    s.channel_settings = {
        ct.GLOBAL: cs(tick_interval_ms=33, default_fanout_interval_ms=50),
        ct.SPATIAL: cs(tick_interval_ms=50, default_fanout_interval_ms=100),
        ct.ENTITY: cs(tick_interval_ms=50, default_fanout_interval_ms=100)}
    if subworld is not None:
        s.channel_settings[ct.SUBWORLD] = cs(tick_interval_ms=subworld[0],
                                             default_fanout_interval_ms=subworld[1])


class StallClock(FixedClock):
    """FixedClock whose ``time.sleep`` moves the clock instead of the thread:
    a chaos stall costs its tick exactly ``stall_ms`` on both legs, so the
    same ticks blow their budget, break their message drain and freeze the
    recorder on the card and on the CPU."""

    def __enter__(self):
        super().__enter__()
        self._sleep = time.sleep
        time.sleep = self.advance
        return self

    def __exit__(self, *exc):
        time.sleep = self._sleep
        return super().__exit__(*exc)


def stage_counts(P) -> dict:
    """{stage: observations} of ``tick_stage_ms`` so far."""
    return {s.labels["stage"]: int(s.value) for m in P.metrics.tick_stage_ms.collect()
            for s in m.samples if s.name == "tick_stage_ms_count"}


def spans_of_tick(recorder, tick: int) -> dict:
    """{span name: count} of the spans the recorder holds stamped ``tick``."""
    with recorder._rings_lock:
        rings = list(recorder._rings.values())
    names: dict = {}
    for ring in rings:
        for entry in ring.snapshot():
            if entry[5] == tick:
                names[entry[1]] = names.get(entry[1], 0) + 1
    return dict(sorted(names.items()))


def check_perfetto(path: str, wait_s: float = 3.0) -> tuple:
    """scripts/trace_soak.py's pinned Perfetto schema for a dump (written
    off-thread: waits for it, bounded): (valid, note, span names)."""
    doc = None
    deadline = time.monotonic() + wait_s
    while doc is None:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            if time.monotonic() > deadline:
                return False, f"unreadable: {e}", set()
            time.sleep(0.05)
    try:
        assert set(doc) >= {"traceEvents", "displayTimeUnit", "otherData"}
        for ev in doc["traceEvents"]:
            assert set(ev) >= {"name", "ph", "ts", "pid", "tid", "args"}
            assert ev["ph"] in ("X", "i")
            assert "tick" in ev["args"]
            if ev["ph"] == "X":
                assert ev["dur"] >= 0
    except AssertionError as e:
        return False, f"schema violation: {e}", set()
    return True, f"{len(doc['traceEvents'])} events", {ev["name"] for ev in doc["traceEvents"]}


class TraceWorld(GatewayWorld):
    """13a: scripts/trace_soak.py's live world in-process on a fixed clock
    (``StallClock``), through one package's modules ``P``: its cells world
    (``config``), the master owning GLOBAL and the 4 servers claiming the
    cells, the soak's ``EntitySim`` entities, ``clients`` stub clients each
    sending one forward to the master a tick and the first ``followers``
    following an entity (sphere, extent 60) through the legacy follower
    path (the query plane is off); the guard off, so the controller steps
    the engine on the loop thread; the recorder on (16,384-span rings, 150
    ticks a dump, dumps under ``scratch``); the scenario's chaos armed.
    Each tick: moves and forwards, every entity channel, GLOBAL (the
    controller), every spatial channel. Records per tick what the gateway
    produced and what the recorder and its metrics saw."""

    def __init__(self, P, dev: torch.device, clock, scn: dict, config: str, scratch: str,
                 K=None):
        from random import Random

        self.P, self.dev, self.clock, self.scn, self.K = P, dev, clock, scn, K
        reset_gateway(P)
        soak_pins(P, dev, scn["tables"])
        s = P.settings.global_settings
        s.device_guard_enabled = s.slo_enabled = False
        s.trace_enabled = True
        self.recorder = P.tracing.recorder
        self.recorder.configure(enabled=True, ring_spans=16384, dump_ticks=150,
                                dump_path=scratch, anomaly_cooldown_s=2.0, origin="lockstep")
        P.message.init_message_map()
        P.channel.init_channels()
        P.sim_models.register_sim_types()
        P.controller.init_spatial_controller(config)
        ctl = self.ctl = P.controller.get_spatial_controller()
        self.eng = ctl.engine
        if P.port:
            check(self.eng.device.type == dev.type, f"the engine is on {self.eng.device}, not {dev}")
        self.conns: list = []
        self._servers()
        self.gch = P.channel.get_global_channel()
        self.sim = EntitySim(P, ctl, scn["entities"], scn["storm"], Random(scn["seed"] ^ 0x7247))
        self.sim.create_entities()
        self.entity_channels = [P.channel.get_channel(e) for e in self.sim.entity_ids]
        self.clients = [self.conn(1000 + i, "CLIENT") for i in range(scn["clients"])]
        for i, client in enumerate(self.clients):
            client.pit = f"soak-client-{i}"
            if i < scn["followers"]:
                ctl.register_follow_interest(
                    client, self.sim.entity_ids[i % len(self.sim.entity_ids)],
                    P.ops.AOI_SPHERE, extent=(60.0, 0.0))
        self.seq = [0] * scn["clients"]
        self.crowd: list = []
        self.handovers, self.step_ms = [], []
        self.transfers = 0
        self._wrap()
        P.chaos.arm(scn["chaos"])

    def _wrap(self) -> None:
        """Record each tick's handovers, time the device step (the engine's
        tick up to its handover list, where the host waits for the card)
        on the host's perf_counter, and, in the port, count the engine's
        device-to-host transfers: the consume blob's fetch, each
        ``interest_rows`` and the query plane's changed-rows fetch."""
        eng = self.eng
        tick, handover_list = eng.tick, eng.handover_list
        started = []

        def timed_tick(*args, **kwargs):
            started.append(time.perf_counter())
            return tick(*args, **kwargs)

        def recorded_handovers(result):
            rows = handover_list(result)
            if started:
                self.step_ms.append((time.perf_counter() - started.pop()) * 1e3)
            self.handovers.append(rows)
            return rows

        eng.tick, eng.handover_list = timed_tick, recorded_handovers
        if self.P.port:
            consume, interest_rows = eng.consume, eng.interest_rows

            def counted_consume(result):
                self.transfers += result.get("consume_host") is None
                return consume(result)

            def counted_rows(result, q_rows):
                self.transfers += 1
                return interest_rows(result, q_rows)

            changed_rows = eng.query_changed_rows

            def counted_changed(result):
                self.transfers += isinstance(result.get("query_blob"), torch.Tensor)
                return changed_rows(result)

            eng.consume, eng.interest_rows = counted_consume, counted_rows
            eng.query_changed_rows = counted_changed

    def drive(self, t: int) -> None:
        P, sim = self.P, self.sim
        sim.jitter_step()
        if t == self.scn["storm_at"]:
            self.crowd = sim.storm_gather()
        elif t == self.scn["disperse_at"]:
            sim.disperse(self.crowd)
            self.crowd = []
        handler = P.message.handle_client_to_server_user_message
        for i, client in enumerate(self.clients):
            msg = P.wire_pb2.ServerForwardMessage(
                clientConnId=client.id, payload=np.array([i, self.seq[i]], "<u4").tobytes())
            pack = P.wire_pb2.MessagePack(channelId=0, msgType=100)
            self.gch.put_message(msg, handler, client, pack)
            self.seq[i] += 1

    def tick(self, t: int) -> dict:
        P, eng, K, rec = self.P, self.eng, self.K, self.recorder
        self.clock.advance(GATEWAY_TICK_S)
        self.drive(t)
        now = time.monotonic_ns()
        chans = P.channel.all_channels()
        cuda = self.dev.type == "cuda"
        crossings, steps, transfers = len(self.handovers), len(self.step_ms), self.transfers
        stages, readbacks = stage_counts(P), P.metrics.follower_readbacks._value.get()
        anomalies, fires = len(rec.anomalies), P.chaos.chaos.fire_counts()
        before = K.launch_counts() if K is not None else None
        sync(self.dev)
        with (Reads() if cuda else contextlib.nullcontext()) as reads:
            t0 = time.perf_counter()
            for ch in self.entity_channels:
                ch.tick_once(now)
            self.gch.tick_once(now)
            for cid in self.spatial:
                chans[cid].tick_once(now)
            t1 = time.perf_counter()
        tables = hashlib.sha256()
        for cid in self.spatial:
            tables.update(chans[cid].get_data_message().SerializeToString(deterministic=True))
        after = stage_counts(P)
        obs = dict(
            handovers=[r for rows in self.handovers[crossings:] for r in rows],
            tables=tables.hexdigest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns},
            spans=spans_of_tick(rec, rec.tick - 1),
            stages={k: v - stages.get(k, 0) for k, v in after.items() if v != stages.get(k, 0)},
            readbacks=int(P.metrics.follower_readbacks._value.get() - readbacks),
            anomalies=[(a["trigger"], a["detail"], a["tick"]) for a in rec.anomalies[anomalies:]],
            fires={p: n - fires.get(p, 0) for p, n in P.chaos.chaos.fire_counts().items()
                   if n != fires.get(p, 0)},
            transfers=self.transfers - transfers if P.port else None,
            tick_ms=(t1 - t0) * 1e3,
            step_ms=self.step_ms[steps] if len(self.step_ms) > steps else None,
            reads=reads.count if cuda else None)
        if K is not None:
            obs["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
        return obs

    def dumps(self) -> list:
        """(trigger, path) of every anomaly that froze a dump."""
        return [(a["trigger"], a["path"]) for a in self.recorder.anomalies if "path" in a]

    def close(self) -> None:
        self.P.chaos.disarm()
        reset_gateway(self.P)


def run_trace_lockstep(P, dev: torch.device, scn: dict, config: str, scratch: str,
                       K=None) -> tuple:
    """One leg of 13a: (per-tick observations, report). The dumps are read
    after the fixed clock is left (the check waits on the host's clock)."""
    import os

    leg_dir = os.path.join(scratch, f"{dev.type}-{P.channel.__name__.split('.')[0]}")
    os.makedirs(leg_dir, exist_ok=True)
    t_leg = time.perf_counter()
    with StallClock() as clock:
        world = TraceWorld(P, dev, clock, scn, config, leg_dir, K)
        if K is not None:
            K.reset_launch_counts()
        obs = [world.tick(t) for t in range(scn["ticks"])]
        report = dict(dumps=world.dumps(), step_ms=list(world.step_ms),
                      fires=P.chaos.chaos.fire_counts(), eng=world.eng,
                      launches=K.launch_counts() if K is not None else None,
                      n_shards=world.eng._mesh.size if getattr(world.eng, "_mesh", None) else 1)
        if K is not None:
            report["kernels"] = uncounted(K, lambda: elastic_live_kernels(K, world.eng, (4, 4)))
        world.close()
        del world
    report["dump_checks"] = [(trigger, os.path.basename(path)) + check_perfetto(path)
                             for trigger, path in report["dumps"]]
    report["secs"] = time.perf_counter() - t_leg
    del report["eng"]
    return obs, report


def engine_tick_counter(eng) -> list:
    """Counts the engine's ticks (on any thread) in the returned one-item list."""
    ticks, tick = [0], eng.tick

    def counted(*args, **kwargs):
        ticks[0] += 1
        return tick(*args, **kwargs)

    eng.tick = counted
    return ticks




class SoakStats:
    """scripts/chaos_soak.py's SoakStats: the forwards each client wrote and
    each client's sequence numbers the master drained, and the clients'
    outages."""

    def __init__(self):
        self.client_sent: dict = {}
        self.drained: dict = {}
        self.disconnects = self.reconnects = self.auth_retries = 0
        self.recovery_latencies: list = []


async def soak_boot_world(P, host: str, server_port: int, stats: SoakStats, stop,
                          on_server_pack=None) -> list:
    """scripts/chaos_soak.py's _boot_world: the master possesses GLOBAL (its
    drain unpacks every routed forward into ``stats.drained``) and 4 spatial
    servers claim their blocks through CREATE_CHANNEL over TCP (each server's
    drain hands every MessagePack to ``on_server_pack``, as the failover soak
    re-wraps it); returns the drain task and the streams of each socket (a
    stream writer nothing refers to closes its socket), the master's first,
    once all 16 cells are owned."""
    import asyncio
    import struct

    from google.protobuf.message import DecodeError

    MT, CT = P.types.MessageType, P.types.ChannelType

    def on_master_pack(mp) -> None:
        if mp.msgType < 100:
            return
        sfm = P.wire_pb2.ServerForwardMessage()
        try:  # a corrupted frame's remains are skipped, as the script skips them
            sfm.ParseFromString(mp.msgBody)
            cid, seq = struct.unpack("<II", sfm.payload[:8])
        except (DecodeError, struct.error):
            return
        stats.drained.setdefault(cid, []).append(seq)

    socks = []
    reader, writer = await asyncio.open_connection(host, server_port)
    await soak_auth(P, reader, writer, "soak-master")
    writer.write(soak_frame(P, MT.CREATE_CHANNEL, P.control_pb2.CreateChannelMessage(
        channelType=CT.GLOBAL).SerializeToString()))
    await writer.drain()
    socks.append((asyncio.ensure_future(soak_read_frames(P, reader, on_master_pack, stop)),
                  reader, writer))
    for i in range(4):
        r, w = await asyncio.open_connection(host, server_port)
        await soak_auth(P, r, w, f"soak-spatial-{i}")
        w.write(soak_frame(P, MT.CREATE_CHANNEL, P.control_pb2.CreateChannelMessage(
            channelType=CT.SPATIAL, subOptions=P.control_pb2.ChannelSubscriptionOptions(
                dataAccess=P.types.ChannelDataAccess.WRITE_ACCESS)).SerializeToString()))
        await w.drain()
        socks.append((asyncio.ensure_future(
            soak_read_frames(P, r, on_server_pack or (lambda mp: None), stop)), r, w))
    s = P.settings.global_settings
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        spatial = [ch for cid, ch in P.channel.all_channels().items()
                   if s.spatial_channel_id_start <= cid < s.entity_channel_id_start]
        if len(spatial) == 16 and all(ch.has_owner() for ch in spatial):
            return socks
        await asyncio.sleep(0.1)
    raise RuntimeError("spatial world failed to come up")


async def soak_client_loop(P, idx: int, host: str, port: int, rate: float, stats: SoakStats,
                           stop, send_stop) -> None:
    """scripts/chaos_soak.py's _client_loop: connect, auth, stream
    sequence-stamped forwards at ``rate``; reconnect when the socket dies,
    counting the outage and its recovery latency in ``stats``."""
    import asyncio

    seq, interval, disconnected_at = 0, 1.0 / rate, None
    while not stop.is_set():
        writer = None
        try:
            reader, writer = await asyncio.open_connection(host, port)
            await soak_auth(P, reader, writer, f"soak-client-{idx}", timeout=1.5)
        except (ConnectionError, OSError, TimeoutError):
            stats.auth_retries += 1
            if writer is not None:
                writer.close()
            await asyncio.sleep(0.1)
            continue
        if disconnected_at is not None:
            stats.recovery_latencies.append(time.monotonic() - disconnected_at)
            stats.reconnects += 1
            disconnected_at = None
        reader_task = asyncio.ensure_future(soak_read_frames(P, reader, lambda mp: None, stop))
        try:
            while not stop.is_set():
                if reader_task.done():
                    raise ConnectionError("gateway closed the socket")
                if send_stop.is_set():
                    await asyncio.sleep(0.2)
                    continue
                writer.write(soak_frame(P, 100, np.array([idx, seq], "<u4").tobytes()))
                await writer.drain()
                seq += 1
                stats.client_sent[idx] = stats.client_sent.get(idx, 0) + 1
                await asyncio.sleep(interval)
        except (ConnectionError, OSError):
            stats.disconnects += 1
            disconnected_at = time.monotonic()
        finally:
            reader_task.cancel()
            writer.close()
        if disconnected_at is None:
            break


async def live_listeners(P, host: str) -> tuple:
    """The SERVER and CLIENT TCP listeners on ephemeral ports of ``host``,
    and the flush pump's and the unauthenticated-connection reaper's
    tasks: (server listener, client listener, tasks)."""
    import asyncio

    CT = P.types.ConnectionType
    server_srv = await P.server.start_listening(CT.SERVER, "tcp", f"{host}:0")
    client_srv = await P.server.start_listening(CT.CLIENT, "tcp", f"{host}:0")
    return server_srv, client_srv, [asyncio.ensure_future(P.server.flush_loop()),
                                    asyncio.ensure_future(P.ddos.unauth_reaper_loop())]


def stage_stats(P, d: dict) -> dict:
    """scripts/trace_soak.py's _stage_stats: count, mean, p50 and p99 of
    each stage of ``tick_stage_ms`` in a scrape delta."""
    stages: dict = {}
    for (name, labels), value in d.items():
        ld = dict(labels)
        if name == "tick_stage_ms_count" and value > 0:
            stages.setdefault(ld["stage"], {})["count"] = int(value)
        elif name == "tick_stage_ms_sum" and "stage" in ld:
            stages.setdefault(ld["stage"], {})["sum_ms"] = value
    q = P.invariants.histogram_quantile
    out = {}
    for st, e in sorted(stages.items()):
        if e.get("count"):
            out[st] = dict(count=e["count"], mean_ms=e.get("sum_ms", 0.0) / e["count"],
                           p50_ms=q(d, "tick_stage_ms", 0.50, stage=st) or 0.0,
                           p99_ms=q(d, "tick_stage_ms", 0.99, stage=st) or 0.0)
    return out


def delivery_stats(P, d: dict) -> dict:
    """scripts/obs_soak.py's _delivery_stats: count, mean, p50 and p99 of
    ``delivery_latency_ms`` per (channel type, path) in a scrape delta."""
    series: dict = {}
    for (name, labels), value in d.items():
        ld = dict(labels)
        if name == "delivery_latency_ms_count" and value > 0:
            series.setdefault((ld["channel_type"], ld["path"]), {})["count"] = int(value)
        elif name == "delivery_latency_ms_sum" and "path" in ld:
            series.setdefault((ld["channel_type"], ld["path"]), {})["sum_ms"] = value
    q = P.invariants.histogram_quantile
    return {f"{ct}/{path}": dict(
        count=e["count"], mean_ms=e.get("sum_ms", 0.0) / e["count"],
        p50_ms=q(d, "delivery_latency_ms", 0.50, channel_type=ct, path=path) or 0.0,
        p99_ms=q(d, "delivery_latency_ms", 0.99, channel_type=ct, path=path) or 0.0)
        for (ct, path), e in sorted(series.items()) if e.get("count")}


async def trace_live(P, dev: torch.device, p: dict, scratch: str, n_dev: int, tables: dict,
                     K=None) -> dict:
    """13b: scripts/trace_soak.py's phase 1 through one package's gateway,
    in-process on this asyncio loop: TCP listeners on loopback, the flush
    pump, the master and 4 spatial servers, ``clients`` clients streaming
    forwards, the soak's entities and followers on the cells world at
    MeshDevices ``n_dev`` with the engine on ``dev``, the guard off, the
    recorder on, the scenario armed for ``live_s`` with one storm, then
    ``quiesce_s``. Returns the soak's report, plus the engine's ticks and
    (with ``K``) the kernels' launches over the phase."""
    import asyncio
    import os
    from random import Random

    reset_gateway(P)
    soak_pins(P, dev, tables)
    s = P.settings.global_settings
    s.device_guard_enabled = s.slo_enabled = False
    s.trace_enabled = True
    recorder = P.tracing.recorder
    recorder.configure(enabled=True, ring_spans=16384, dump_ticks=150, dump_path=scratch,
                       anomaly_cooldown_s=2.0, origin="live")
    P.sim_models.register_sim_types()
    P.connection.init_connections(SERVER_FSM, CLIENT_FSM)
    P.channel.init_channels()
    P.ddos.init_anti_ddos()
    P.controller.init_spatial_controller(cells_config(n_dev, scratch))
    ctl = P.controller.get_spatial_controller()
    engine_ticks = engine_tick_counter(ctl.engine)
    before = K.launch_counts() if K is not None else None
    baseline = P.invariants.scrape()
    P.chaos.arm(p["scenario"])
    host = "127.0.0.1"
    server_srv, client_srv, tasks = await live_listeners(P, host)
    client_port = client_srv.sockets[0].getsockname()[1]
    stop, send_stop = asyncio.Event(), asyncio.Event()
    stats = SoakStats()
    try:
        servers = await soak_boot_world(P, host, server_srv.sockets[0].getsockname()[1], stats,
                                        stop)
        tasks += [task for task, _, _ in servers]
        sim = EntitySim(P, ctl, p["entities"], p["storm_size"], Random(p["seed"] ^ 0x7247))
        sim.create_entities()
        tasks += [asyncio.ensure_future(soak_client_loop(
            P, i, host, client_port, p["msg_rate"], stats, stop, send_stop))
            for i in range(p["clients"])]
        deadline, followers = time.monotonic() + 10.0, 0
        while time.monotonic() < deadline and followers < p["followers"]:
            for conn in list(P.connection.all_connections().values()):
                if followers >= p["followers"]:
                    break
                if ((getattr(conn, "pit", "") or "").startswith("soak-client-")
                        and not conn.is_closing() and conn.id not in ctl._followers):
                    ctl.register_follow_interest(
                        conn, sim.entity_ids[followers % len(sim.entity_ids)],
                        P.ops.AOI_SPHERE, extent=(60.0, 0.0))
                    followers += 1
            await asyncio.sleep(0.2)
        t0, stormed, crowd = time.monotonic(), False, []
        while time.monotonic() - t0 < p["live_s"]:
            sim.jitter_step()
            if not stormed and time.monotonic() - t0 > p["live_s"] * 0.3:
                crowd, stormed = sim.storm_gather(), True
            elif crowd and time.monotonic() - t0 > p["live_s"] * 0.7:
                sim.disperse(crowd)
                crowd = []
            await asyncio.sleep(0.1)
        send_stop.set()
        fires = dict(P.chaos.chaos.fire_counts())
        P.chaos.disarm()
        await asyncio.sleep(p["quiesce_s"])
        d = P.invariants.delta(P.invariants.scrape(), baseline)
        dumps, anomalies_total = [], {}
        for a in recorder.anomalies:
            anomalies_total[a["trigger"]] = anomalies_total.get(a["trigger"], 0) + 1
            if "path" in a:
                ok, note, names = check_perfetto(a["path"])
                dumps.append(dict(trigger=a["trigger"], tick=a["tick"], detail=a["detail"],
                                  path=os.path.basename(a["path"]), perfetto_valid=ok,
                                  note=note, device_step="device_step" in names))
        total = P.invariants.sample_total
        return dict(
            stages=stage_stats(P, d), anomaly_dumps=dumps, anomalies_total=anomalies_total,
            trace_dumps_total={"tick_budget": int(total(d, "trace_dumps_total",
                                                        trigger="tick_budget"))},
            follower_readbacks_total=int(total(d, "follower_readbacks_total")),
            batched_ingest=batched_ingest(P),
            followers=followers, recorder=recorder.stats(), chaos_fires=fires,
            clients=p["clients"], entities=p["entities"], frames_sent=sum(stats.client_sent.values()),
            engine_ticks=engine_ticks[0],
            launches=({n: c - before[n] for n, c in K.launch_counts().items()}
                      if K is not None else None))
    finally:
        stop.set()
        send_stop.set()
        P.chaos.disarm()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        server_srv.close()
        client_srv.close()
        reset_gateway(P)


def batched_ingest(P) -> bool:
    """Whether the package's connections take the batched ingest path, the
    only one that records the ``ingest`` stage: it needs the native codec's
    ``parse_forward`` (ROADMAP F19)."""
    return getattr(P.connection._native_codec, "parse_forward", None) is not None


def trace_live_checks(r: dict) -> list:
    """scripts/trace_soak.py's invariants of its phase 1 (the federation
    ones apart), as (name, held, detail); ``ingest`` is expected only where
    the native codec runs the batched ingest path (F19)."""
    missing = [s for s in TRACE_STAGES if s not in r["stages"]
               and (s != "ingest" or r["batched_ingest"])]
    budget = [d for d in r["anomaly_dumps"] if d["trigger"] == "tick_budget"]
    return [
        ("every_tick_stage_measured", not missing, f"missing {missing}"),
        ("tick_budget_anomaly_dump_written",
         budget and r["trace_dumps_total"]["tick_budget"] > 0, r["trace_dumps_total"]),
        ("anomaly_dumps_are_valid_perfetto", all(d["perfetto_valid"] for d in r["anomaly_dumps"]),
         [(d["path"], d["note"]) for d in r["anomaly_dumps"]]),
        ("follower_readbacks_counted", r["follower_readbacks_total"] > 0,
         r["follower_readbacks_total"])]


def overhead_world(P, dev: torch.device, tables: dict, scratch: str,
                   channel_settings=None) -> tuple:
    """Both soaks' phase-3 world through one package: the controller on 4x4
    cells of 100 m (one server, no border) with 64 entities at mid-cell, the
    engine on ``dev`` with ``tables``, the ladder off, the recorder on with
    no dump possible in the window; ``channel_settings(P)``, when given,
    before GLOBAL is made. Returns (settings, GLOBAL, controller,
    [(eid, x, z)])."""
    reset_gateway(P)
    s = P.settings.global_settings
    s.development = False
    if P.port:
        s.spatial_device = dev.type
    for name, value in tables.items():
        setattr(s, name, value)
    s.overload_enabled = False
    s.trace_enabled = True
    recorder = P.tracing.recorder
    recorder.configure(enabled=True, ring_spans=16384, dump_path=scratch,
                       anomaly_cooldown_s=1e9)
    recorder._last_dump_at = time.monotonic()
    if channel_settings is not None:
        s.channel_settings = channel_settings(P)
        P.sim_models.register_sim_types()
    P.channel.init_channels()
    gch = P.channel.get_global_channel()
    ctl = P.controller._controller_registry["TPUSpatialController"]()
    ctl.load_config(dict(WorldOffsetX=0, WorldOffsetZ=0, GridWidth=100, GridHeight=100,
                         GridCols=4, GridRows=4, ServerCols=1, ServerRows=1,
                         ServerInterestBorderSize=0))
    P.controller.set_spatial_controller(ctl)
    eids = []
    for i in range(64):
        eid = s.entity_channel_id_start + 1 + i
        x, z = (i % 4) * 100.0 + 50.0, (i // 4 % 4) * 100.0 + 50.0
        ctl.track_entity(eid, P.controller.SpatialInfo(x, 0, z))
        eids.append((eid, x, z))
    return s, gch, ctl, eids


def alternate(one_tick, ticks: int, rounds: int, arm) -> tuple:
    """30 warm-up ticks off the clock, then ``ticks * rounds`` pairs of ticks
    with ``arm(True)`` and ``arm(False)`` in turn, the collector off:
    (median ns on, median ns off)."""
    import gc

    for _ in range(30):
        one_tick()
    on, off = [], []
    enabled = gc.isenabled()
    gc.disable()
    try:
        for _ in range(ticks * rounds):
            arm(True)
            on.append(one_tick())
            arm(False)
            off.append(one_tick())
    finally:
        if enabled:
            gc.enable()
        arm(True)
    return statistics.median(on), statistics.median(off)


def trace_overhead(P, dev: torch.device, tables: dict, ticks: int, rounds: int, scratch: str,
                   seed: int = TRACE_SOAK_SEED, K=None) -> dict:
    """13c: scripts/trace_soak.py's phase 3 through one package: the GLOBAL
    tick (the controller's device step and 8 entity updates a tick) with the
    recorder on and off tick by tick; the median of each arm, the overhead
    in percent, and the raw cost of one span."""
    from random import Random

    s, gch, ctl, eids = overhead_world(P, dev, tables, scratch)
    recorder = P.tracing.recorder
    rng = Random(seed ^ 0x0ffd)

    def one_tick() -> int:
        for eid, x, z in rng.sample(eids, 8):
            ctl.observe_entity(eid, P.controller.SpatialInfo(
                x + rng.uniform(-20, 20), 0, z + rng.uniform(-20, 20)))
        t0 = time.perf_counter_ns()
        gch.tick_once(gch.get_time())
        return time.perf_counter_ns() - t0

    before = K.launch_counts() if K is not None else None
    tick_on, tick_off = alternate(one_tick, ticks, rounds,
                                  lambda on: setattr(recorder, "enabled", on))
    n = 100_000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        recorder.span("bench", recorder.now())
    span_cost_ns = (time.perf_counter_ns() - t0) / n
    out = dict(tick_ns_enabled=int(tick_on), tick_ns_disabled=int(tick_off),
               overhead_pct=(tick_on - tick_off) / tick_off * 100.0, span_cost_ns=span_cost_ns,
               ticks=30 + 2 * ticks * rounds, tables=dict(tables))
    if K is not None:
        out["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
        eng = ctl.engine
        out["kernels"] = soak_live_kernels(K, eng.grid, eng._d_positions, eng._d_valid,
                                           eng._d_queries)
    reset_gateway(P)
    return out


class ListConn(GatewayConn):
    """tests/helpers.py's StubConnection: keeps every outbound context."""

    def __init__(self, P, conn_id: int, kind: str = "CLIENT"):
        super().__init__(P, conn_id, kind)
        self.sent: list = []

    def send(self, ctx) -> None:
        self.sent.append(ctx)


def obs_overhead(P, dev: torch.device, tables: dict, ticks: int, rounds: int, scratch: str,
                 seed: int = OBS_SOAK_SEED, K=None) -> dict:
    """13e: scripts/obs_soak.py's phase 3 through one package: the GLOBAL
    and SUBWORLD ticks (the device step, 8 entity updates, one stamped
    update a tick fanned out to 8 subscribers, the burn-rate evaluation)
    with the SLO plane on and off tick by tick."""
    from random import Random

    def channel_settings(P):
        cs, ct = P.settings.ChannelSettings, P.types.ChannelType
        return {ct.GLOBAL: cs(tick_interval_ms=10, default_fanout_interval_ms=20),
                ct.SUBWORLD: cs(tick_interval_ms=10, default_fanout_interval_ms=20)}

    s, gch, ctl, eids = overhead_world(P, dev, tables, scratch, channel_settings)
    ct = P.types.ChannelType
    rng = Random(seed ^ 0x0b5d)
    sub_ch = P.channel.create_channel(ct.SUBWORLD, None)
    sub_ch.init_data(P.sim_pb2.SimSpatialChannelData(), None)
    for i in range(8):
        P.sub.subscribe_to_channel(ListConn(P, 9000 + i), sub_ch,
                                   P.control_pb2.ChannelSubscriptionOptions(
                                       dataAccess=P.types.ChannelDataAccess.READ_ACCESS,
                                       fanOutIntervalMs=10, skipSelfUpdateFanOut=False))
    slo = P.slo.slo
    slo.configure(enabled=True)
    estart, seq = s.entity_channel_id_start, [0]

    def one_tick() -> int:
        for eid, x, z in rng.sample(eids, 8):
            ctl.observe_entity(eid, P.controller.SpatialInfo(
                x + rng.uniform(-20, 20), 0, z + rng.uniform(-20, 20)))
        upd = P.sim_pb2.SimSpatialChannelData()
        e = estart + 2000
        upd.entities[e].entityId = e
        upd.entities[e].transform.position.x = float(seq[0] % 89)
        seq[0] += 1
        sub_ch.data.on_update(upd, sub_ch.get_time(), 999, now_ns=sub_ch.get_time(),
                              ingest_ns=time.monotonic_ns())
        t0 = time.perf_counter_ns()
        gch.tick_once(gch.get_time())
        sub_ch.tick_once(sub_ch.get_time())
        return time.perf_counter_ns() - t0

    before = K.launch_counts() if K is not None else None
    tick_on, tick_off = alternate(one_tick, ticks, rounds, lambda on: setattr(slo, "enabled", on))
    out = dict(tick_ns_enabled=int(tick_on), tick_ns_disabled=int(tick_off),
               overhead_pct=(tick_on - tick_off) / tick_off * 100.0,
               ticks=30 + 2 * ticks * rounds, tables=dict(tables))
    if K is not None:
        out["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
    reset_gateway(P)
    return out


def ops_get(port: int, path: str, timeout: float = 3.0) -> tuple:
    """(status, parsed JSON or text) from the ops surface on loopback."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            body, code = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body.decode(errors="replace")


def readyz_flips(P, port: int, wal_dir: str) -> dict:
    """scripts/obs_soak.py's /readyz matrix: 200, 503 with the guard set
    FAILED directly (not terminal: its text must not say so, F8), 200 back
    at ACTIVE; 200 with the WAL armed, 503 wedged, 200 unwedged. The ops
    requests block the loop, as the soak's do, so no tick runs between a
    state and its read."""
    import os

    guard, DS, wal, s = P.guard.guard, P.guard.DeviceState, P.wal.wal, P.settings.global_settings
    codes, docs = [], []

    def ready() -> int:
        code, doc = ops_get(port, "/readyz")
        codes.append(code)
        docs.append(doc)
        return code

    ok = ready() == 200
    guard._set_state(DS.FAILED)
    terminal = getattr(guard, "terminal", False)  # the JAX guard is never terminal (F8)
    ok = ready() == 503 and ok
    guard._set_state(DS.ACTIVE)
    ok = ready() == 200 and ok
    os.makedirs(wal_dir, exist_ok=True)
    s.wal_path = os.path.join(wal_dir, "g.wal")
    wal.start(s.wal_path)
    ok = ready() == 200 and ok
    wal._wedged = True
    ok = ready() == 503 and ok
    wal._wedged = False
    ok = ready() == 200 and ok
    wal.stop()
    s.wal_path = ""
    return dict(codes=codes, flip_ok=ok, failed_terminal=terminal,
                failed_device=docs[1]["components"]["device"],
                wedged_wal=docs[4]["components"]["wal"])


async def obs_live(P, dev: torch.device, p: dict, scratch: str, n_dev: int, tables: dict,
                   K=None) -> dict:
    """13d: scripts/obs_soak.py's phase 1 through one package's gateway,
    in-process on this asyncio loop: the trace soak's world with the guard
    on (the step on its worker) and the SLO plane on, the ops surface on an
    ephemeral port, an updater at ``update_rate`` and ``viewers`` viewers on
    a SUBWORLD channel (tick 20 ms, fan-out 50 ms) over TCP; warm-up, the
    steady window (delivery latency), the ops probes and the /readyz flips,
    then the breach window under the scenario. Returns the soak's report,
    plus the engine's ticks and (with ``K``) the kernels' launches."""
    import asyncio
    import os
    from random import Random

    reset_gateway(P)
    soak_pins(P, dev, tables, subworld=(20, 50))
    s = P.settings.global_settings
    s.device_guard_enabled = True
    s.trace_enabled = s.slo_enabled = True
    recorder, slo = P.tracing.recorder, P.slo.slo
    recorder.configure(enabled=True, ring_spans=16384, dump_ticks=150, dump_path=scratch,
                       anomaly_cooldown_s=2.0, origin="obs-live")
    slo.configure(enabled=True)
    P.sim_models.register_sim_types()
    P.connection.init_connections(SERVER_FSM, CLIENT_FSM)
    P.channel.init_channels()
    P.ddos.init_anti_ddos()
    P.controller.init_spatial_controller(cells_config(n_dev, scratch))
    ctl = P.controller.get_spatial_controller()
    engine_ticks = engine_tick_counter(ctl.engine)
    before = K.launch_counts() if K is not None else None
    ops = P.opshttp.serve_ops(0, host="127.0.0.1")
    inv = P.invariants
    baseline = inv.scrape()
    MT = P.types.MessageType
    host = "127.0.0.1"
    server_srv, client_srv, tasks = await live_listeners(P, host)
    client_port = client_srv.sockets[0].getsockname()[1]
    stop, send_stop = asyncio.Event(), asyncio.Event()
    stats = SoakStats()
    try:
        servers = await soak_boot_world(P, host, server_srv.sockets[0].getsockname()[1], stats,
                                        stop)
        tasks += [task for task, _, _ in servers]
        sim = EntitySim(P, ctl, p["entities"], 20, Random(p["seed"] ^ 0x0b5))
        sim.create_entities()
        tasks += [asyncio.ensure_future(soak_client_loop(
            P, i, host, client_port, p["msg_rate"], stats, stop, send_stop))
            for i in range(p["clients"])]
        sub_ch = P.channel.create_channel(P.types.ChannelType.SUBWORLD, None)
        sub_ch.init_data(P.sim_pb2.SimSpatialChannelData(), None)
        up_reader, up_writer = await asyncio.open_connection(host, client_port)
        await soak_auth(P, up_reader, up_writer, "obs-updater")
        viewers = []
        for i in range(p["viewers"]):
            r, w = await asyncio.open_connection(host, client_port)
            await soak_auth(P, r, w, f"obs-viewer-{i}")
            viewers.append((r, w))
        await asyncio.sleep(0.3)

        def conn_of(pit: str):
            for conn in P.connection.all_connections().values():
                if conn.pit == pit and not conn.is_closing():
                    return conn
            raise RuntimeError(f"no server-side conn for {pit}")

        opts = P.control_pb2.ChannelSubscriptionOptions
        access = P.types.ChannelDataAccess
        P.sub.subscribe_to_channel(conn_of("obs-updater"), sub_ch, opts(
            dataAccess=access.WRITE_ACCESS, fanOutIntervalMs=1000, skipSelfUpdateFanOut=True))
        for i in range(p["viewers"]):
            P.sub.subscribe_to_channel(conn_of(f"obs-viewer-{i}"), sub_ch, opts(
                dataAccess=access.READ_ACCESS, fanOutIntervalMs=50, skipSelfUpdateFanOut=False))

        async def updater_loop():
            eid = s.entity_channel_id_start + 9001
            seq, interval = 0, 1.0 / p["update_rate"]
            while not stop.is_set() and not send_stop.is_set():
                upd = P.sim_pb2.SimSpatialChannelData()
                upd.entities[eid].entityId = eid
                upd.entities[eid].transform.position.x = float(seq % 97)
                body = P.control_pb2.ChannelDataUpdateMessage(
                    data=P.anyutil.pack_any(upd)).SerializeToString()
                up_writer.write(soak_frame(P, int(MT.CHANNEL_DATA_UPDATE), body,
                                           channel_id=sub_ch.id))
                try:
                    await up_writer.drain()
                except (ConnectionError, OSError):
                    return
                seq += 1
                await asyncio.sleep(interval)

        tasks.append(asyncio.ensure_future(updater_loop()))
        tasks += [asyncio.ensure_future(soak_read_frames(P, r, lambda mp: None, stop))
                  for r, _ in viewers + [(up_reader, up_writer)]]
        await asyncio.sleep(p["warmup_s"] / 2)
        crowd = sim.storm_gather()
        await asyncio.sleep(1.0)
        sim.disperse(crowd)
        for _ in range(6):
            sim.jitter_step()
            await asyncio.sleep(0.1)
        await asyncio.sleep(p["warmup_s"] / 2)
        steady_base, t0 = inv.scrape(), time.monotonic()
        while time.monotonic() - t0 < p["steady_s"]:
            sim.jitter_step()
            await asyncio.sleep(0.1)
        steady = delivery_stats(P, inv.delta(inv.scrape(), steady_base))
        code, health = ops_get(ops.port, "/healthz")
        healthz_ok = code == 200 and health.get("ok") is True
        code, intro = ops_get(ops.port, "/introspect")
        introspect_ok = (code == 200 and intro.get("ready") is True
                         and intro.get("connections", {}).get("CLIENT", 0) >= p["clients"]
                         and "delivery_p99" in intro.get("slo", {}))
        metrics_ok = ops_get(ops.port, "/metrics")[0] == 200
        readyz = readyz_flips(P, ops.port, os.path.join(scratch, "obs_wal"))
        slo.configure(enabled=True)
        metric_before = {name: inv.sample_total(None, "slo_breaches_total", slo=name)
                         for name in slo.status()}
        P.chaos.arm(p["scenario"])
        t0 = time.monotonic()
        while time.monotonic() - t0 < p["breach_s"]:
            sim.jitter_step()
            await asyncio.sleep(0.1)
        fires = dict(P.chaos.chaos.fire_counts())
        P.chaos.disarm()
        await asyncio.sleep(p["quiesce_s"])
        send_stop.set()
        await asyncio.sleep(0.5)
        breaches = {k: v for k, v in slo.breach_counts.items() if v > 0}
        ledger_exact = all(
            slo.breach_counts[name] == int(inv.sample_total(None, "slo_breaches_total", slo=name)
                                           - metric_before.get(name, 0.0))
            for name in slo.breach_counts)
        breach_dumps = [dict(trigger=a["trigger"], detail=a["detail"], tick=a["tick"],
                             path=os.path.basename(a["path"]),
                             perfetto_valid=check_perfetto(a["path"])[0])
                        for a in recorder.anomalies if a["trigger"] == "slo_breach" and "path" in a]
        full = inv.delta(inv.scrape(), baseline)
        guard = P.guard.guard
        return dict(
            steady=steady, full_run=delivery_stats(P, full), delivery_total=slo.delivery_total,
            slo_status=slo.status(), breaches=breaches, breach_ledger_matches_metric=ledger_exact,
            breach_dumps=breach_dumps,
            burn_peak={name: max(e["burn"] for e in slo.breach_events if e["slo"] == name)
                       for name in {e["slo"] for e in slo.breach_events}},
            staleness_samples=int(inv.sample_total(full, "fanout_staleness_ms_count")),
            readyz=readyz["codes"], readyz_flip_ok=readyz["flip_ok"],
            readyz_failed=readyz, healthz_ok=healthz_ok, introspect_ok=introspect_ok,
            metrics_ok=metrics_ok, ops_port=ops.port, chaos_fires=fires, clients=p["clients"],
            viewers=p["viewers"], frames_sent=sum(stats.client_sent.values()),
            guard_state=guard.state.name, device_state=int(P.metrics.device_state._value.get()),
            engine_ticks=engine_ticks[0],
            launches=({n: c - before[n] for n, c in K.launch_counts().items()}
                      if K is not None else None))
    finally:
        stop.set()
        send_stop.set()
        P.chaos.disarm()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        server_srv.close()
        client_srv.close()
        P.opshttp.reset_ops()
        reset_gateway(P)


def obs_live_checks(r: dict) -> list:
    """scripts/obs_soak.py's invariants of its phase 1 (the federation ones
    apart), as (name, held, detail), plus the /readyz body of a FAILED
    guard that is not terminal (F8) and the guard ACTIVE at the end."""
    host = next((k for k in r["steady"] if k.endswith("/host")), None)
    st = r["steady"].get(host, {})
    return [
        ("delivery_p99_measured_under_load", host is not None and st["count"] > 100, st),
        ("delivery_p99_bounded", host is not None and st["p99_ms"] < 1000.0, st),
        ("delivery_p50_bounded", host is not None and st["p50_ms"] < 100.0, st),
        ("slo_breach_fired", sum(r["breaches"].values()) > 0, r["breaches"]),
        ("breach_ledger_matches_metric", r["breach_ledger_matches_metric"], ""),
        ("breach_anomaly_dump_perfetto_valid",
         r["breach_dumps"] and all(d["perfetto_valid"] for d in r["breach_dumps"]),
         r["breach_dumps"]),
        ("readyz_flipped_on_device_fault", r["readyz_flip_ok"], r["readyz"]),
        ("readyz_failed_is_not_terminal",
         not r["readyz_failed"]["failed_terminal"]
         and "terminally" not in r["readyz_failed"]["failed_device"]["detail"],
         r["readyz_failed"]["failed_device"]),
        ("healthz_and_introspect_served",
         r["healthz_ok"] and r["introspect_ok"] and r["metrics_ok"], ""),
        ("staleness_sampled", r["staleness_samples"] > 0, r["staleness_samples"]),
        ("device_active_at_the_end", r["guard_state"] == "ACTIVE" and r["device_state"] == 0,
         (r["guard_state"], r["device_state"]))]


def phase_trace_lockstep(K, dev, scn: dict, n_dev: int) -> tuple:
    """13a: ``TraceWorld`` on the card against a lockstep CPU leg, tick for
    tick. Returns (K1/K2 launches, the kernels' entries at its shapes)."""
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="trace-lockstep-")
    t_phase = time.perf_counter()
    try:
        config = cells_config(n_dev, scratch)
        card, rc = run_trace_lockstep(P, dev, scn, config, scratch, K)
        cpu, rp = run_trace_lockstep(P, torch.device("cpu"), scn, config, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    ticks = scn["ticks"]
    check(len(card) == len(cpu) == ticks, f"13a: {len(card)} card and {len(cpu)} cpu ticks")
    for t in range(ticks):
        where = first_gateway_diff(card[t], cpu[t])
        check(where is None, f"13a tick {t}: cuda and cpu differ: {where}")
    n = rc["n_shards"]
    for t, o in enumerate(card):
        check(o["launches"] == {name: n for name in o["launches"]},
              f"13a tick {t}: launches {o['launches']}, not {n} each (one per shard)")
        check(o["reads"] == 2, f"13a tick {t}: {o['reads']} device reads, not 2 (the consume "
                               f"blob and the followers' interest rows)")
    for leg, obs in (("cuda", card), ("cpu", cpu)):
        check({o["transfers"] for o in obs} == {2}, f"13a {leg}: engine transfers a tick "
                                                    f"{sorted({o['transfers'] for o in obs})}")
        check({o["readbacks"] for o in obs} == {1}, f"13a {leg}: follower_readbacks_total a tick "
                                                    f"{sorted({o['readbacks'] for o in obs})}")
    fires = rc["fires"]
    check(fires == rp["fires"] and min(fires.values()) >= 3, f"13a chaos fires {fires} vs "
                                                             f"{rp['fires']}")
    stages: dict = {}
    for o in card:
        for k, v in o["stages"].items():
            stages[k] = stages.get(k, 0) + v
    missing = [s for s in TRACE_STAGES if s != "ingest" and not stages.get(s)]
    check(not missing, f"13a: stages never measured: {missing} ({stages})")
    for leg, r in (("cuda", rc), ("cpu", rp)):
        budget = [d for d in r["dump_checks"] if d[0] == "tick_budget"]
        check(budget, f"13a {leg}: no tick_budget dump")
        for trigger, path, ok, note, names in r["dump_checks"]:
            check(ok and "device_step" in names, f"13a {leg} dump {path}: {note}, "
                                                 f"device_step {'device_step' in names}")
    anomalies = [a for o in card for a in o["anomalies"]]
    k1, k2 = rc["kernels"]["assign_count"], rc["kernels"]["aoi"]
    print(f"13a trace lockstep: {ticks} GLOBAL ticks of config/spatial_tpu_cells_2x2.json at "
          f"MeshDevices {n_dev} ({scn['tables']['tpu_entity_capacity']} slots, "
          f"{scn['tables']['tpu_query_capacity']} query rows), {scn['entities']} entities "
          f"(storm of {scn['storm']} at tick {scn['storm_at']}, dispersed at "
          f"{scn['disperse_at']}), {scn['clients']} clients' forwards, {scn['followers']} "
          f"followers on the legacy path, the guard off, the recorder on, chaos fires {fires}: "
          f"cuda equals the CPU leg on every tick: handovers "
          f"({sum(len(o['handovers']) for o in card)}), tables, every outbound stream (the "
          f"followers' interest diffs), the recorder's spans a tick, the stage counts "
          f"{stages}, follower_readbacks_total 1 a tick, the anomalies ({len(anomalies)}: "
          f"{sorted({a[0] for a in anomalies})}); 2 device reads and 2 engine transfers a tick; "
          f"launches {rc['launches']}; dumps cuda {len(rc['dump_checks'])} / cpu "
          f"{len(rp['dump_checks'])}, each Perfetto-valid with device_step spans; phase "
          f"{time.perf_counter() - t_phase:.1f} s (card leg {rc['secs']:.1f} s, cpu leg "
          f"{rp['secs']:.1f} s)")
    for leg, obs, r in (("cuda", card, rc), ("cpu", cpu, rp)):
        print(f"13a on {leg}: tick {tick_stats([o['tick_ms'] for o in obs[1:]])}; device step "
              f"(engine tick to its handover list, the loop thread) "
              f"{tick_stats(r['step_ms'][1:])}")
    for name, k in (("assign_count", k1), ("aoi", k2)):
        print(f"13a {name} on the live tensors ({k['shape']}): exact; alone {k['ms']:.4f} ms "
              f"(events, bare launches), plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']})")
    return rc["launches"], rc["kernels"]


def phase_trace_live(K, dev, n_dev: int, p: dict) -> dict:
    """13b: ``trace_live`` on the card, held to the trace soak's invariants
    and to K1/K2 once per shard on every engine tick."""
    import asyncio
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="trace-live-")
    t_phase = time.perf_counter()
    try:
        r = asyncio.run(trace_live(P, dev, p, scratch, n_dev, DEFAULT_TABLES, K))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name, ok, detail in trace_live_checks(r):
        check(ok, f"13b: {name}: {detail}")
    want = {name: n_dev * r["engine_ticks"] for name in r["launches"]}
    check(r["engine_ticks"] > 0 and r["launches"] == want,
          f"13b: launches {r['launches']} in {r['engine_ticks']} engine ticks")
    budget = [d for d in r["anomaly_dumps"] if d["trigger"] == "tick_budget"]
    print(f"13b trace live: {p['live_s']:g} s, {p['clients']} clients at {p['msg_rate']:g} msg/s "
          f"({r['frames_sent']} forwards), {p['entities']} entities, {r['followers']} followers, "
          f"a storm of {p['storm_size']}, MeshDevices {n_dev}, "
          f"{DEFAULT_TABLES['tpu_entity_capacity']} slots / "
          f"{DEFAULT_TABLES['tpu_query_capacity']} query rows; "
          f"every stage measured ("
          + ("ingest too: the native codec's batched ingest path" if r["batched_ingest"] else
             "but ingest, not measured: no native codec here, and without it neither package "
             "records that stage (F19)")
          + f"), trace_dumps_total{{tick_budget}} "
          f"{r['trace_dumps_total']['tick_budget']}, {len(r['anomaly_dumps'])} dumps "
          f"Perfetto-valid ({len(budget)} tick_budget, device_step in "
          f"{sum(d['device_step'] for d in budget)}), anomalies {r['anomalies_total']}, "
          f"follower_readbacks_total {r['follower_readbacks_total']}, chaos fires "
          f"{r['chaos_fires']}, recorder {r['recorder']}; launches {r['launches']} in "
          f"{r['engine_ticks']} engine ticks; phase {time.perf_counter() - t_phase:.1f} s")
    print("13b stages (count, mean / p50 / p99 ms): " + "; ".join(
        f"{st} {e['count']}, {e['mean_ms']:.4f} / {e['p50_ms']:.4f} / {e['p99_ms']:.4f}"
        for st, e in r["stages"].items()))
    return r


def phase_overheads(K, dev, tp: dict, op: dict) -> dict:
    """13c and 13e: each soak's overhead phase at its own tables and at the
    gateway's defaults, K1/K2 once on every tick, each exact on the live
    tensors; the ratios printed against their bars, pass or fail."""
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="overhead-")
    out: dict = {}
    try:
        for label, tables in (("soak", OVERHEAD_TABLES), ("default", DEFAULT_TABLES)):
            t0 = time.perf_counter()
            tr = trace_overhead(P, dev, tables, tp["overhead_ticks"], tp["overhead_rounds"],
                                scratch, K=K)
            ob = obs_overhead(P, dev, tables, op["overhead_ticks"], op["overhead_rounds"],
                              scratch, K=K)
            for what, r in (("13c", tr), ("13e", ob)):
                check(r["launches"] == {name: r["ticks"] for name in r["launches"]},
                      f"{what} ({label}): launches {r['launches']} in {r['ticks']} ticks")
            out[label] = dict(trace=tr, obs=ob)
            k1, k2 = tr["kernels"]["assign_count"], tr["kernels"]["aoi"]
            print(f"13c trace overhead ({tables['tpu_entity_capacity']} slots, "
                  f"{tables['tpu_query_capacity']} query rows; 4x4 cells of 100 m, 64 entities, "
                  f"8 updates a tick; {tp['overhead_ticks']} x {tp['overhead_rounds']} "
                  f"alternated): median tick on {tr['tick_ns_enabled'] / 1e6:.4f} ms, off "
                  f"{tr['tick_ns_disabled'] / 1e6:.4f} ms, overhead {tr['overhead_pct']:.3f}% "
                  f"({'under' if tr['overhead_pct'] < 3.0 else 'NOT under'} the 3% bar), "
                  f"span_cost_ns {tr['span_cost_ns']:.1f}; K1 and K2 {tr['ticks']} launches in "
                  f"{tr['ticks']} ticks; K1 ({k1['shape']}) exact, alone {k1['ms']:.4f} ms, "
                  f"plain {k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.6f} ms; K2 "
                  f"({k2['shape']}) exact, alone {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} "
                  f"ms, bound {k2['bound_ms']:.6f} ms")
            print(f"13e obs overhead ({tables['tpu_entity_capacity']} slots; the same world, a "
                  f"SUBWORLD of 8 subscribers, one stamped update a tick; "
                  f"{op['overhead_ticks']} x {op['overhead_rounds']} alternated): median tick "
                  f"on {ob['tick_ns_enabled'] / 1e6:.4f} ms, off "
                  f"{ob['tick_ns_disabled'] / 1e6:.4f} ms, overhead {ob['overhead_pct']:.3f}% "
                  f"({'under' if ob['overhead_pct'] < 2.0 else 'NOT under'} the 2% bar); "
                  f"{time.perf_counter() - t0:.1f} s for both")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return out


def phase_obs_live(K, dev, n_dev: int, p: dict) -> dict:
    """13d: ``obs_live`` on the card, held to the obs soak's invariants,
    the /readyz flips and K1/K2 once per shard on every engine tick."""
    import asyncio
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="obs-live-")
    t_phase = time.perf_counter()
    try:
        r = asyncio.run(obs_live(P, dev, p, scratch, n_dev, DEFAULT_TABLES, K))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name, ok, detail in obs_live_checks(r):
        check(ok, f"13d: {name}: {str(detail)[:300]}")
    want = {name: n_dev * r["engine_ticks"] for name in r["launches"]}
    check(r["engine_ticks"] > 0 and r["launches"] == want,
          f"13d: launches {r['launches']} in {r['engine_ticks']} engine ticks")
    host = next(k for k in r["steady"] if k.endswith("/host"))
    st = r["steady"][host]
    print(f"13d obs live: {p['clients']} clients at {p['msg_rate']:g} msg/s, an updater at "
          f"{p['update_rate']:g}/s and {p['viewers']} viewers on SUBWORLD {host}, "
          f"{p['entities']} entities, the guard on (the step on its worker), MeshDevices "
          f"{n_dev}, {DEFAULT_TABLES['tpu_entity_capacity']} slots; steady {p['steady_s']:g} s: "
          f"delivery_latency_ms {st['count']} samples, p50 {st['p50_ms']:.4f} ms, p99 "
          f"{st['p99_ms']:.4f} ms, mean {st['mean_ms']:.4f} ms (the < 5 ms p99: "
          f"{'met' if st['p99_ms'] < 5.0 else 'not met'}); breach window {p['breach_s']:g} s: "
          f"breaches {r['breaches']} equal to slo_breaches_total, burn peak {r['burn_peak']}, "
          f"{len(r['breach_dumps'])} slo_breach dumps Perfetto-valid; /readyz {r['readyz']} "
          f"(FAILED: {r['readyz_failed']['failed_device']['detail']}; wedged WAL: "
          f"{r['readyz_failed']['wedged_wal']['detail']}); /healthz, /introspect, "
          f"/metrics 200; staleness samples {r['staleness_samples']}; guard {r['guard_state']}, "
          f"device_state {r['device_state']}; chaos fires {r['chaos_fires']}; launches "
          f"{r['launches']} in {r['engine_ticks']} engine ticks; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    print("13d delivery (count, p50 / p99 ms) over the whole run: " + "; ".join(
        f"{k} {e['count']}, {e['p50_ms']:.4f} / {e['p99_ms']:.4f}"
        for k, e in r["full_run"].items()))
    return r


def phase_trace_obs(K, dev) -> tuple:
    """13a-13e on the cells world at MeshDevices = min(cards, 8). Returns
    ({path: launches}, {kernel: {case: entry}}, 13b's stages and whether it
    ran the batched ingest, which 17a's stage check reads)."""
    n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
    launches, kernels = phase_trace_lockstep(K, dev, trace_lockstep_scenario(), n_dev)
    tp, op = trace_params(), obs_params()
    live = phase_trace_live(K, dev, n_dev, tp)
    overheads = phase_overheads(K, dev, tp, op)
    obs = phase_obs_live(K, dev, n_dev, op)
    entries = {name: {"13a_cells_shard": kernels[name],
                      **{f"13c_{label}_tables": o["trace"]["kernels"][name]
                         for label, o in overheads.items()}}
               for name in kernels}
    return ({"trace_soak": launches, "obs_soak": obs["launches"]}, entries,
            dict(stages=live["stages"], batched_ingest=live["batched_ingest"]))


# ---- phase 14: the live chaos soak and the overload ladder -------------------

SOAK_SCENARIO_SEED = 20260803  # both scripts' scenarios
# The gateway's device tables, which phase 14 runs in place of the soaks' 256 / 32.
GATEWAY_CAPACITIES = dict(entity_capacity=DEFAULT_TABLES["tpu_entity_capacity"],
                          query_capacity=DEFAULT_TABLES["tpu_query_capacity"])


def chaos_scenario() -> dict:
    """scripts/chaos_soak.py's DEFAULT_SCENARIO: an undersized cells-plane
    bucket, and transport resets, truncated and corrupt frames, EOF races,
    fake queue-full bursts, tick-budget and device-dispatch stalls."""
    return {"name": "cells-soak", "seed": SOAK_SCENARIO_SEED,
            "config_overrides": {"CellBucket": 6}, "faults": [
                {"point": "transport.reset", "every_n": 700, "max_fires": 30},
                {"point": "transport.truncate", "every_n": 1150, "max_fires": 15},
                {"point": "transport.corrupt", "every_n": 1400, "max_fires": 15},
                {"point": "connection.eof_race", "every_n": 1800, "max_fires": 10},
                {"point": "connection.queue_full", "every_n": 900, "burst": 3},
                {"point": "channel.tick_budget", "every_n": 500, "stall_ms": 15, "max_fires": 60},
                {"point": "device.dispatch_stall", "every_n": 90, "stall_ms": 40,
                 "max_fires": 40}]}


def chaos_params(**kw) -> dict:
    """scripts/chaos_soak.py's SoakParams (its paths apart)."""
    return dict(dict(duration_s=120.0, clients=24, entities=160, msg_rate=25.0,
                     storm_every_s=10.0, storm_size=48, recovery_deadline_s=8.0,
                     tick_p99_bound_s=1.5, quiesce_s=10.0, entity_capacity=256,
                     query_capacity=32, scenario=chaos_scenario()), **kw)


def overload_params(**kw) -> dict:
    """scripts/overload_soak.py's OverloadSoakParams (its paths and scenario
    apart: ``overload_scenario`` makes that from these)."""
    return dict(dict(warmup_s=10.0, saturation_s=35.0, recover_deadline_s=15.0, quiesce_s=6.0,
                     clients=16, observers=4, entities=128, msg_rate=20.0, storm_every_s=6.0,
                     storm_size=64, handover_batch_cap=4, down_hold_s=1.0, global_tick_ms=50,
                     tick_p99_bounds=(1.0, 1.5, 2.0, 2.0), entity_capacity=256,
                     query_capacity=32, require_handover_defer=True,
                     require_update_priority=True), **kw)


def overload_scenario(p: dict) -> dict:
    """scripts/overload_soak.py's default_scenario(p): the saturation window
    [warmup, warmup + saturation) of the clock since arming, in which every
    device dispatch stalls 1.8 GLOBAL budgets and every 6th message handler
    12 ms, and transport resets from 2 s into it."""
    t0, t1 = p["warmup_s"], p["warmup_s"] + p["saturation_s"]
    return {"name": "overload-saturation", "seed": SOAK_SCENARIO_SEED,
            "config_overrides": {"CellBucket": 6}, "faults": [
                {"point": "device.dispatch_stall", "every_n": 1,
                 "stall_ms": round(p["global_tick_ms"] * 1.8), "start_at_s": t0,
                 "stop_at_s": t1},
                {"point": "channel.tick_budget", "every_n": 6, "stall_ms": 12,
                 "start_at_s": t0, "stop_at_s": t1},
                {"point": "transport.reset", "every_n": 150, "start_at_s": t0 + 2.0,
                 "stop_at_s": t1}]}


def overload_lockstep_params(**kw) -> dict:
    """14a: the overload soak's widths on a fixed clock: a warmup of 2 s and
    a saturation window of 12 s of that clock (the stalls move it) with a
    storm every 3 s, then recovery until L0 (at most ``recover_deadline_s``)
    and ``quiesce_s`` without traffic; at most ``max_ticks`` GLOBAL ticks."""
    return overload_params(**dict(dict(warmup_s=2.0, saturation_s=12.0, storm_every_s=3.0,
                                       quiesce_s=1.0, max_ticks=400), **kw))


def ladder_pins(P, dev, p: dict, global_ms: tuple, cell_ms: tuple, queryplane: bool) -> None:
    """The chaos and overload soaks' pins: development mode; the balancer,
    partitioning, the device guard, the SLO plane, the flight recorder and
    federation off; the ladder on; the query plane ``queryplane`` and the
    sim plane off; GLOBAL ``global_ms`` and SPATIAL and ENTITY ``cell_ms``
    (tick, fan-out interval in ms); the device tables of ``p``; the engine
    on ``dev``."""
    s = P.settings.global_settings
    s.development = True
    if P.port:
        s.spatial_device = dev.type
    s.balancer_enabled = s.partition_enabled = False
    s.device_guard_enabled = s.slo_enabled = s.trace_enabled = False
    P.tracing.recorder.configure(enabled=False)
    P.federation.reset_federation()
    s.federation_config = ""
    s.overload_enabled = True
    s.queryplane_enabled = queryplane
    s.sim_enabled = False
    s.tpu_entity_capacity, s.tpu_query_capacity = p["entity_capacity"], p["query_capacity"]
    cs, ct = P.settings.ChannelSettings, P.types.ChannelType
    s.channel_settings = {
        ct.GLOBAL: cs(tick_interval_ms=global_ms[0], default_fanout_interval_ms=global_ms[1]),
        ct.SPATIAL: cs(tick_interval_ms=cell_ms[0], default_fanout_interval_ms=cell_ms[1]),
        ct.ENTITY: cs(tick_interval_ms=cell_ms[0], default_fanout_interval_ms=cell_ms[1])}


def overload_pins(P, dev, p: dict) -> None:
    """scripts/overload_soak.py's pins: ``ladder_pins`` with GLOBAL at the
    budget ``global_tick_ms`` (fan-out 50 ms), SPATIAL and ENTITY at twice it
    (fan-out 100 ms), the query plane at its default (on), and the ladder's
    down-hold and handover batch cap from ``p``."""
    tick = p["global_tick_ms"]
    ladder_pins(P, dev, p, (tick, 50), (2 * tick, 100), queryplane=True)
    s = P.settings.global_settings
    s.overload_down_hold_s = p["down_hold_s"]
    s.overload_handover_batch_cap = p["handover_batch_cap"]


def soak_census(P, ctl, entity_ids: list) -> dict:
    """Both soaks' zero-loss books: entities neither in a device slot nor
    tracked on the host, and entities in no spatial channel's data or in
    more than one."""
    s = P.settings.global_settings
    placement: dict = {}
    for cid, ch in P.channel.all_channels().items():
        if not s.spatial_channel_id_start <= cid < s.entity_channel_id_start:
            continue
        for eid in getattr(ch.get_data_message(), "entities", None) or ():
            placement[eid] = placement.get(eid, 0) + 1
    return dict(
        lost_tracking=[e for e in entity_ids
                       if ctl.engine.slot_of_entity(e) is None and e not in ctl._last_positions],
        missing=[e for e in entity_ids if placement.get(e, 0) == 0],
        duped=[e for e in entity_ids if placement.get(e, 0) > 1])


def metric_sheds(d: dict) -> dict:
    """{reason: count} of ``overload_sheds_total`` in a scrape delta (a zero
    delta is a label an earlier run registered: nothing shed)."""
    return {dict(labels)["reason"]: int(value) for (name, labels), value in d.items()
            if name == "overload_sheds_total" and value}


class LateConn(GatewayConn):
    """A client stub whose AUTH arrives while the ladder is at L3: keeps the
    types of the messages it is sent."""

    def __init__(self, P, conn_id: int):
        super().__init__(P, conn_id, "CLIENT")
        self.state = P.types.ConnectionState.UNAUTHENTICATED
        self.msg_types: list = []

    def send(self, ctx) -> None:
        super().send(ctx)
        self.msg_types.append(ctx.msg_type)


class OverloadWorld(GatewayWorld):
    """14a: scripts/overload_soak.py's world in-process on a fixed clock
    (``StallClock``), through one package's modules ``P``: the cells world
    (``config``, with the scenario's CellBucket 6), the master owning GLOBAL
    and the 4 servers claiming the cells, the soak's ``EntitySim`` entities
    (a jitter step a tick; a storm every ``storm_every_s`` inside the
    saturation window until 6 s before it closes, the last crowd dispersed
    when it closes), ``clients`` stub clients each sending one
    sequence-stamped forward to the master a tick (20 msg/s at a 50 ms
    tick), ``observers`` stub clients subscribed READ at 200 ms to spatial
    channels ``start + idx % 16`` (priority 2: the first the L2 shed
    withholds), the overload soak's pins, and ``overload_scenario(p)`` armed
    at tick 0. Each tick advances the clock one GLOBAL budget and ticks
    every entity channel, GLOBAL (the controller) and every spatial channel
    once; on each of the first 3 ticks at L3 a new stub client's AUTH goes
    through the package's own handler on GLOBAL. Records per tick the
    ladder, the shed ledger, the overflow, the handovers (the deferred
    ones too), the tables and every outbound stream."""

    ADMISSIONS = 3

    def __init__(self, P, dev: torch.device, clock, p: dict, config: str, K=None):
        from random import Random

        self.P, self.dev, self.clock, self.p, self.K = P, dev, clock, p, K
        reset_gateway(P)
        overload_pins(P, dev, p)
        P.message.init_message_map()
        P.channel.init_channels()
        P.sim_models.register_sim_types()
        P.controller.init_spatial_controller(config)
        ctl = self.ctl = P.controller.get_spatial_controller()
        self.eng = ctl.engine
        if P.port:
            check(self.eng.device.type == dev.type, f"the engine is on {self.eng.device}, not {dev}")
        self.conns: list = []
        self._servers()
        self.gch = P.channel.get_global_channel()
        self.sim = EntitySim(P, ctl, p["entities"], p["storm_size"],
                             Random(SOAK_SCENARIO_SEED ^ 0x0F0F))
        self.sim.create_entities()
        self.entity_channels = [P.channel.get_channel(e) for e in self.sim.entity_ids]
        self.clients = [self.conn(1000 + i, "CLIENT") for i in range(p["clients"])]
        start = P.settings.global_settings.spatial_channel_id_start
        for idx in range(p["observers"]):
            P.sub.subscribe_to_channel(
                self.conn(2000 + idx, "CLIENT"), P.channel.get_channel(start + idx % 16),
                P.control_pb2.ChannelSubscriptionOptions(
                    dataAccess=P.types.ChannelDataAccess.READ_ACCESS, fanOutIntervalMs=200))
        self.seq = [0] * p["clients"]
        self.late: list = []
        self.crowd: list = []
        self.storm_at = p["warmup_s"] + 1.0
        self.traffic = True
        self.handovers, self.step_ms = [], []
        self.transfers = 0
        self._wrap()
        self.baseline = P.invariants.scrape()
        P.chaos.arm(overload_scenario(p))
        self.armed_at = time.monotonic()

    _wrap = TraceWorld._wrap

    def now(self) -> float:
        """Seconds of the fixed clock since the scenario was armed."""
        return time.monotonic() - self.armed_at

    def drive(self, t: int) -> None:
        P, sim, p = self.P, self.sim, self.p
        if not self.traffic:
            return
        now = self.now()
        sim.jitter_step()
        sat_close = p["warmup_s"] + p["saturation_s"]
        if p["warmup_s"] <= now < sat_close - max(p["storm_every_s"], 6.0) and now >= self.storm_at:
            if self.crowd:
                sim.disperse(self.crowd)
            self.crowd = sim.storm_gather()
            self.storm_at += p["storm_every_s"]
        elif now >= sat_close and self.crowd:
            sim.disperse(self.crowd)
            self.crowd = []
        handler = P.message.handle_client_to_server_user_message
        for i, client in enumerate(self.clients):
            msg = P.wire_pb2.ServerForwardMessage(
                clientConnId=client.id, payload=np.array([i, self.seq[i]], "<u4").tobytes())
            self.gch.put_message(msg, handler, client, P.wire_pb2.MessagePack(channelId=0,
                                                                              msgType=100))
            self.seq[i] += 1
        if P.overload.governor.level >= 3 and len(self.late) < self.ADMISSIONS:
            late = LateConn(P, 3000 + len(self.late))
            P.connection._all_connections[late.id] = late
            self.conns.append(late)
            self.late.append(late)
            self.gch.put_message(
                P.control_pb2.AuthMessage(playerIdentifierToken=f"ov-late-{len(self.late)}",
                                          loginToken="soak"),
                P.message.handle_auth, late,
                P.wire_pb2.MessagePack(channelId=0, msgType=P.types.MessageType.AUTH))

    def tick(self, t: int) -> dict:
        P, K, ctl = self.P, self.K, self.ctl
        self.clock.advance(self.p["global_tick_ms"] / 1000.0)
        self.drive(t)
        now = time.monotonic_ns()
        chans = P.channel.all_channels()
        cuda = self.dev.type == "cuda"
        crossings, transfers = len(self.handovers), self.transfers
        fires = P.chaos.chaos.fire_counts()
        overflow = P.metrics.tpu_cell_overflow_total._value.get()
        before = K.launch_counts() if K is not None else None
        sync(self.dev)
        with (Reads() if cuda else contextlib.nullcontext()) as reads:
            t0 = time.perf_counter()
            for ch in self.entity_channels:
                ch.tick_once(now)
            self.gch.tick_once(now)
            for cid in self.spatial:
                chans[cid].tick_once(now)
            t1 = time.perf_counter()
        tables = hashlib.sha256()
        for cid in self.spatial:
            tables.update(chans[cid].get_data_message().SerializeToString(deterministic=True))
        gov = P.overload.governor
        obs = dict(
            handovers=[r for rows in self.handovers[crossings:] for r in rows],
            deferred=sorted(ctl._deferred_crossings),
            tables=tables.hexdigest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns},
            governor=(int(gov.level), gov.pressure, sorted(gov.components.items()),
                      [(d["from"], d["to"], d["t"], d["pressure"]) for d in gov.transitions]),
            sheds=dict(sorted(gov.shed_counts.items())),
            overflow=int(P.metrics.tpu_cell_overflow_total._value.get() - overflow),
            fires={p: n - fires.get(p, 0) for p, n in P.chaos.chaos.fire_counts().items()
                   if n != fires.get(p, 0)},
            transfers=self.transfers - transfers if P.port else None,
            tick_ms=(t1 - t0) * 1e3, reads=reads.count if cuda else None)
        if K is not None:
            obs["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
        return obs

    def close(self) -> None:
        self.P.chaos.disarm()
        reset_gateway(self.P)


def run_overload_lockstep(P, dev: torch.device, p: dict, config: str, K=None) -> tuple:
    """One leg of 14a: (per-tick observations, report). The saturation
    window [warmup, warmup + saturation) of the armed clock, then recovery
    until L0 (or ``recover_deadline_s`` past the window's close), then
    ``quiesce_s`` without traffic; at most ``max_ticks`` ticks. With ``K``,
    K1 and K2 are held against their plain versions on the live tensors
    after the first tick whose bucket overflows and the first tick at L2 or
    above inside the window."""
    t_leg = time.perf_counter()
    sat_close = p["warmup_s"] + p["saturation_s"]
    with StallClock() as clock:
        world = OverloadWorld(P, dev, clock, p, config, K)
        if K is not None:
            K.reset_launch_counts()
        obs: list = []
        kernels: dict = {}
        quiet_at = closed_at = recovered_at = None
        while len(obs) < p["max_ticks"]:
            o = world.tick(len(obs))
            obs.append(o)
            now, level = world.now(), o["governor"][0]
            if K is not None:
                if o["overflow"] and "overflow" not in kernels:
                    kernels["overflow"] = uncounted(
                        K, lambda: elastic_live_kernels(K, world.eng, (4, 4)))
                if level >= 2 and now < sat_close and "saturation" not in kernels:
                    kernels["saturation"] = uncounted(
                        K, lambda: elastic_live_kernels(K, world.eng, (4, 4)))
            if closed_at is None and now >= sat_close:
                closed_at = len(obs) - 1
            if quiet_at is None and closed_at is not None and (
                    level == 0 or now - sat_close >= p["recover_deadline_s"]):
                world.traffic, quiet_at = False, now
                recovered_at = len(obs) - 1 if level == 0 else None
            elif quiet_at is not None and now - quiet_at >= p["quiesce_s"]:
                break
        inv, gov = P.invariants, P.overload.governor
        msg_busy = P.types.MessageType.SERVER_BUSY
        report = dict(
            census=soak_census(P, world.ctl, world.sim.entity_ids),
            metric_sheds=metric_sheds(inv.delta(inv.scrape(), world.baseline)),
            shed_counts=dict(gov.shed_counts),
            transitions=[(d["from"], d["to"], d["t"]) for d in gov.transitions],
            admitted=len(world.late),
            busy_frames=sum(t == msg_busy for c in world.late for t in c.msg_types),
            late_closed=all(c.is_closing() for c in world.late),
            fires=P.chaos.chaos.fire_counts(), closed_at=closed_at, recovered_at=recovered_at,
            seconds=world.now(), kernels=kernels,
            launches=K.launch_counts() if K is not None else None,
            n_shards=world.eng._mesh.size if getattr(world.eng, "_mesh", None) else 1)
        world.close()
        del world
    report["secs"] = time.perf_counter() - t_leg
    return obs, report


def overload_lockstep_checks(obs: list, r: dict) -> list:
    """14a's invariants of one leg, as (name, held, detail): the ladder
    reached L2 and L3, one step at a time, never rose once it began to
    descend, and was at L0 by the end; the shed ledger equals
    ``overload_sheds_total`` per reason; the low-priority update shed and a
    handover deferral fired; each late client got one ServerBusyMessage,
    counted as ``admission_connection``, and was closed; no entity lost or
    duplicated."""
    levels = [o["governor"][0] for o in obs]
    steps = [to - frm for frm, to, _ in r["transitions"]]
    descent = next((i for i, s in enumerate(steps) if s < 0), len(steps))
    sheds, census = r["shed_counts"], r["census"]
    return [
        ("ladder_reached_at_least_L2", max(levels, default=0) >= 2, max(levels, default=0)),
        ("ladder_reached_L3", max(levels, default=0) == 3, max(levels, default=0)),
        ("ladder_moves_one_step_at_a_time", all(abs(s) == 1 for s in steps), steps),
        ("no_rise_after_the_descent_began", all(s < 0 for s in steps[descent:]), steps),
        ("at_L0_by_the_end", bool(levels) and levels[-1] == 0 and r["recovered_at"] is not None,
         (levels[-1:], r["recovered_at"])),
        ("shed_accounting_exact", r["metric_sheds"] == sheds, (r["metric_sheds"], sheds)),
        ("low_priority_updates_shed", sheds.get("update_priority", 0) > 0, sheds),
        ("handover_deferred", sheds.get("handover_defer", 0) > 0, sheds),
        ("l3_admissions_refused_with_server_busy",
         r["admitted"] == OverloadWorld.ADMISSIONS and r["late_closed"]
         and r["busy_frames"] == sheds.get("admission_connection", 0) == r["admitted"],
         (r["admitted"], r["busy_frames"], sheds.get("admission_connection", 0))),
        ("no_lost_entity_tracking", census["lost_tracking"] == [], census["lost_tracking"]),
        ("every_entity_in_exactly_one_cell", (census["missing"], census["duped"]) == ([], []),
         (census["missing"], census["duped"]))]


def tick_buckets(samples: dict) -> dict:
    """scripts/overload_soak.py's _tick_buckets: {le: cumulative count} of
    the GLOBAL ``channel_tick_duration`` histogram in a scrape."""
    out = {}
    for (name, labels), value in samples.items():
        ld = dict(labels)
        if name == "channel_tick_duration_bucket" and ld.get("channel_type") == "GLOBAL":
            le = ld.get("le")
            out[float("inf") if le == "+Inf" else float(le)] = value
    return out


def bucket_p99(buckets: dict) -> Optional[float]:
    """scripts/overload_soak.py's _bucket_p99: the p99 of cumulative buckets,
    interpolated inside the bucket that holds it (None when empty)."""
    if not buckets:
        return None
    items = sorted(buckets.items())
    total = items[-1][1]
    if total <= 0:
        return None
    target = 0.99 * total
    prev_le, prev_n = 0.0, 0.0
    for le, n in items:
        if n >= target:
            if le == float("inf"):
                return prev_le
            span = n - prev_n
            return prev_le + (le - prev_le) * ((target - prev_n) / span if span > 0 else 1.0)
        prev_le, prev_n = le, n
    return items[-1][0]


async def chaos_live(P, dev: torch.device, p: dict, scratch: str, n_dev: int, K=None) -> dict:
    """14b: scripts/chaos_soak.py's run_soak through one package's gateway,
    in-process on this asyncio loop: TCP listeners on loopback, the flush
    pump, the master (its drain counting every routed forward) and 4 spatial
    servers, ``clients`` clients streaming sequence-stamped forwards and
    reconnecting through every fault, the soak's entities with a storm every
    ``storm_every_s`` on the cells world at MeshDevices ``n_dev`` (with the
    scenario's CellBucket), the engine on ``dev``, the soak's pins (the
    ladder on), the scenario armed for ``duration_s - quiesce_s``, then
    ``quiesce_s`` disarmed. Returns the soak's books, plus the ladder's peak,
    the engine's ticks and (with ``K``) the kernels' launches."""
    import asyncio
    from random import Random

    reset_gateway(P)
    ladder_pins(P, dev, p, (33, 50), (50, 100), queryplane=False)
    P.sim_models.register_sim_types()
    P.connection.init_connections(SERVER_FSM, CLIENT_FSM)
    P.channel.init_channels()
    P.ddos.init_anti_ddos()
    scn = p["scenario"]
    P.controller.init_spatial_controller(cells_config(n_dev, scratch, scn.get("config_overrides")))
    ctl = P.controller.get_spatial_controller()
    engine_ticks = engine_tick_counter(ctl.engine)
    before = K.launch_counts() if K is not None else None
    inv = P.invariants
    baseline = inv.scrape()
    P.chaos.arm(scn)
    host = "127.0.0.1"
    stop, send_stop = asyncio.Event(), asyncio.Event()
    server_srv, client_srv, tasks = await live_listeners(P, host)
    stats = SoakStats()
    try:
        servers = await soak_boot_world(P, host, server_srv.sockets[0].getsockname()[1], stats,
                                        stop)
        tasks += [task for task, _, _ in servers]
        sim = EntitySim(P, ctl, p["entities"], p["storm_size"],
                        Random(scn.get("seed", 0) ^ 0x50AC))
        sim.create_entities()
        client_port = client_srv.sockets[0].getsockname()[1]
        tasks += [asyncio.ensure_future(soak_client_loop(
            P, i, host, client_port, p["msg_rate"], stats, stop, send_stop))
            for i in range(p["clients"])]
        traffic_s = max(p["duration_s"] - p["quiesce_s"], 1.0)
        storm_at, crowd = p["storm_every_s"], []
        t0 = time.monotonic()
        while time.monotonic() - t0 < traffic_s:
            sim.jitter_step()
            now = time.monotonic() - t0
            if now >= storm_at:
                if crowd:
                    sim.disperse(crowd)
                    crowd = []
                # No storm in the final stretch: crossings settle before the books.
                if now < traffic_s - max(p["storm_every_s"] * 0.8, 6.0):
                    crowd = sim.storm_gather()
                storm_at += p["storm_every_s"]
            await asyncio.sleep(0.1)
        if crowd:
            sim.disperse(crowd)
        send_stop.set()
        fires = dict(P.chaos.chaos.fire_counts())
        P.chaos.disarm()
        await asyncio.sleep(p["quiesce_s"])
        d = inv.delta(inv.scrape(), baseline)
        gov = P.overload.governor
        return dict(
            soak_census(P, ctl, sim.entity_ids),
            received=int(inv.sample_total(d, "messages_in_total", conn_type="CLIENT",
                                          msg_type="100")),
            drained=sum(len(v) for v in stats.drained.values()),
            sent=sum(stats.client_sent.values()),
            disordered=[cid for cid, seqs in stats.drained.items()
                        if any(b <= a for a, b in zip(seqs, seqs[1:]))],
            recovery_latencies=list(stats.recovery_latencies), disconnects=stats.disconnects,
            reconnects=stats.reconnects, auth_retries=stats.auth_retries,
            global_tick_p99_s=inv.histogram_quantile(d, "channel_tick_duration", 0.99,
                                                     channel_type="GLOBAL"),
            device_step_p99_s=inv.histogram_quantile(d, "tpu_spatial_step_seconds", 0.99),
            overflow=int(inv.sample_total(d, "tpu_cell_overflow_entities_total")),
            handovers=int(inv.sample_total(d, "handovers_total")),
            fires=fires, points=[r["point"] for r in scn["faults"]],
            peak_level=max((t["to"] for t in gov.transitions), default=0),
            transitions=len(gov.transitions), sheds=dict(gov.shed_counts),
            engine=str(ctl.engine.device) if P.port else None, engine_ticks=engine_ticks[0],
            launches=({n: c - before[n] for n, c in K.launch_counts().items()}
                      if K is not None else None))
    finally:
        stop.set()
        send_stop.set()
        P.chaos.disarm()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        server_srv.close()
        client_srv.close()
        reset_gateway(P)


def chaos_live_checks(r: dict, p: dict) -> list:
    """scripts/chaos_soak.py's invariants, under its names, as (name, held,
    detail)."""
    worst = max(r["recovery_latencies"], default=0.0)
    silent = [point for point in r["points"] if r["fires"].get(point, 0) == 0]
    p99 = r["global_tick_p99_s"]
    return [
        ("no_lost_entity_tracking", r["lost_tracking"] == [], r["lost_tracking"]),
        ("every_entity_in_exactly_one_cell", (r["missing"], r["duped"]) == ([], []),
         (r["missing"], r["duped"])),
        ("received_equals_owner_drained", r["received"] == r["drained"],
         (r["received"], r["drained"])),
        ("received_le_sent", r["received"] <= r["sent"], (r["received"], r["sent"])),
        ("per_client_order_no_dup", r["disordered"] == [], r["disordered"]),
        ("reconnect_within_deadline", worst <= p["recovery_deadline_s"],
         f"worst {worst} s of {len(r['recovery_latencies'])} recoveries"),
        ("all_disconnects_recovered", r["disconnects"] - r["reconnects"] == 0,
         (r["disconnects"], r["reconnects"])),
        ("global_tick_p99_bounded", p99 is not None and p99 <= p["tick_p99_bound_s"], p99),
        ("cells_overflow_shed_fired", r["overflow"] > 0, r["overflow"]),
        ("handovers_orchestrated", r["handovers"] > 0, r["handovers"]),
        ("every_fault_point_fired", silent == [], silent)]


async def overload_live(P, dev: torch.device, p: dict, scratch: str, n_dev: int,
                        K=None, settle_max_s: float = 30.0) -> dict:
    """14c: scripts/overload_soak.py's run_overload_soak through one
    package's gateway, in-process on this asyncio loop: the chaos soak's
    world (its servers, entities and storms) with busy-aware clients that
    back off for a ServerBusyMessage's retryAfterMs, ``observers``
    low-priority READ subscribers at 200 ms, the overload soak's pins and a
    poller attributing GLOBAL tick-histogram deltas to the level each 250 ms
    window began at; a settle to L0 (at least 3 s, at most ``settle_max_s``:
    the script's 30 s), the governor re-zeroed, then warmup, the saturation
    window (``overload_scenario``), recovery until L0 or
    ``recover_deadline_s``, and ``quiesce_s``. Returns the soak's books,
    plus the engine's ticks and (with ``K``) the kernels' launches."""
    import asyncio
    from random import Random

    reset_gateway(P)
    overload_pins(P, dev, p)
    P.sim_models.register_sim_types()
    P.connection.init_connections(SERVER_FSM, CLIENT_FSM)
    P.channel.init_channels()
    P.ddos.init_anti_ddos()
    scn = overload_scenario(p)
    P.controller.init_spatial_controller(cells_config(n_dev, scratch, scn["config_overrides"]))
    ctl = P.controller.get_spatial_controller()
    engine_ticks = engine_tick_counter(ctl.engine)
    before = K.launch_counts() if K is not None else None
    inv, gov = P.invariants, P.overload.governor
    MT, s = P.types.MessageType, P.settings.global_settings
    host = "127.0.0.1"
    stop, send_stop = asyncio.Event(), asyncio.Event()
    server_srv, client_srv, tasks = await live_listeners(P, host)
    client_port = client_srv.sockets[0].getsockname()[1]
    stats = SoakStats()
    busy = dict(seen=0, open=False)
    level_buckets: dict = {}
    timeline: list = []
    t_start = time.monotonic()

    async def poller() -> None:
        prev = tick_buckets(inv.scrape())
        while not stop.is_set():
            level_at_start = int(gov.level)
            await asyncio.sleep(0.25)
            cur = tick_buckets(inv.scrape())
            acc = level_buckets.setdefault(level_at_start, {})
            for le, v in cur.items():
                acc[le] = acc.get(le, 0.0) + (v - prev.get(le, 0.0))
            prev = cur
            timeline.append(dict(t=round(time.monotonic() - t_start, 2), level=int(gov.level),
                                 pressure=round(gov.pressure, 3)))

    async def busy_aware_client(idx: int) -> None:
        """The soak's _busy_aware_client: a ServerBusyMessage during auth
        backs it off for the advertised retryAfterMs."""
        seq, interval = 0, 1.0 / p["msg_rate"]
        await asyncio.sleep(idx * 0.15)  # staggered: no thundering herd in the warmup
        while not stop.is_set():
            writer = None
            try:
                reader, writer = await asyncio.open_connection(host, client_port)
                writer.write(soak_frame(P, MT.AUTH, P.control_pb2.AuthMessage(
                    playerIdentifierToken=f"ov-client-{idx}",
                    loginToken="soak").SerializeToString()))
                await writer.drain()
                dec = P.protocol.FrameDecoder()
                deadline = time.monotonic() + 2.0
                busy_ms, authed = None, False
                while not authed and busy_ms is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("auth timeout")
                    data = await asyncio.wait_for(reader.read(65536), timeout=remaining)
                    if not data:
                        raise ConnectionError("closed during auth")
                    for packet in dec.decode_packets(data):
                        for mp in packet.messages:
                            if mp.msgType == MT.SERVER_BUSY:
                                refusal = P.control_pb2.ServerBusyMessage()
                                refusal.ParseFromString(mp.msgBody)
                                busy_ms = refusal.retryAfterMs or 500
                            elif mp.msgType == MT.AUTH:
                                authed = True
                if busy_ms is not None:
                    if busy["open"]:  # refusals in the settle are not in the books
                        busy["seen"] += 1
                    writer.close()
                    await asyncio.sleep(min(busy_ms / 1000.0, 3.0))
                    continue
            except (ConnectionError, OSError, TimeoutError):
                stats.auth_retries += 1
                if writer is not None:
                    writer.close()
                await asyncio.sleep(0.25)
                continue
            reader_task = asyncio.ensure_future(soak_read_frames(P, reader, lambda mp: None, stop))
            try:
                while not stop.is_set():
                    if reader_task.done():
                        raise ConnectionError("gateway closed the socket")
                    if send_stop.is_set():
                        await asyncio.sleep(0.2)
                        continue
                    writer.write(soak_frame(P, 100, np.array([idx, seq], "<u4").tobytes()))
                    await writer.drain()
                    seq += 1
                    stats.client_sent[idx] = stats.client_sent.get(idx, 0) + 1
                    await asyncio.sleep(interval)
            except (ConnectionError, OSError):
                stats.disconnects += 1
            finally:
                reader_task.cancel()
                writer.close()

    async def observer_client(idx: int) -> None:
        """The soak's _observer_client: READ on spatial channel ``start + idx
        % 16`` at 200 ms (priority 2), retried through refusals and kills."""
        await asyncio.sleep(0.5 + idx * 0.2)  # behind the clients' stagger
        while not stop.is_set():
            try:
                reader, writer = await asyncio.open_connection(host, client_port)
                try:
                    await soak_auth(P, reader, writer, f"ov-observer-{idx}")
                    writer.write(soak_frame(P, MT.SUB_TO_CHANNEL,
                                            P.control_pb2.SubscribedToChannelMessage(
                        subOptions=P.control_pb2.ChannelSubscriptionOptions(
                            dataAccess=P.types.ChannelDataAccess.READ_ACCESS,
                            fanOutIntervalMs=200)).SerializeToString(),
                        channel_id=s.spatial_channel_id_start + idx % 16))
                    await writer.drain()
                    await soak_read_frames(P, reader, lambda mp: None, stop)
                finally:
                    writer.close()
            except (ConnectionError, OSError, TimeoutError):
                pass
            await asyncio.sleep(1.0)

    try:
        servers = await soak_boot_world(P, host, server_srv.sockets[0].getsockname()[1], stats,
                                        stop)
        tasks += [task for task, _, _ in servers]
        sim = EntitySim(P, ctl, p["entities"], p["storm_size"],
                        Random(scn["seed"] ^ 0x0F0F))
        sim.create_entities()
        tasks += [asyncio.ensure_future(busy_aware_client(i)) for i in range(p["clients"])]
        tasks += [asyncio.ensure_future(observer_client(i)) for i in range(p["observers"])]
        # Settle until the governor reads healthy (bounded): the timeline starts at L0.
        settle_from = time.monotonic()
        while time.monotonic() - settle_from < settle_max_s:
            sim.jitter_step()
            await asyncio.sleep(0.5)
            if time.monotonic() - settle_from > 3.0 and gov.level == 0 and gov.pressure < 0.5:
                break
        settle_s = time.monotonic() - t_start
        P.overload.reset_overload()
        baseline = inv.scrape()
        busy["open"] = True
        P.chaos.arm(scn)
        tasks.append(asyncio.ensure_future(poller()))
        t0 = time.monotonic()
        sat_open, sat_close = p["warmup_s"], p["warmup_s"] + p["saturation_s"]
        storm_at, storm_stop = sat_open + 1.0, sat_close - max(p["storm_every_s"], 6.0)
        crowd: list = []
        max_level = observer_subs = 0
        while time.monotonic() - t0 < sat_close:
            now = time.monotonic() - t0
            sim.jitter_step()
            if sat_open <= now < storm_stop and now >= storm_at:
                if crowd:
                    sim.disperse(crowd)
                crowd = sim.storm_gather()
                storm_at += p["storm_every_s"]
            max_level = max(max_level, int(gov.level))
            if not observer_subs:
                observer_subs = sum(
                    1 for cid, ch in P.channel.all_channels().items()
                    if s.spatial_channel_id_start <= cid < s.entity_channel_id_start
                    for c in ch.subscribed_connections
                    if c.connection_type == P.types.ConnectionType.CLIENT)
            await asyncio.sleep(0.1)
        if crowd:
            sim.disperse(crowd)
        closed_at, peak_at_close = time.monotonic(), max_level
        recovered_at = None
        while time.monotonic() - closed_at < p["recover_deadline_s"]:
            sim.jitter_step()
            max_level = max(max_level, int(gov.level))
            if gov.level == 0:
                recovered_at = time.monotonic()
                break
            await asyncio.sleep(0.2)
        send_stop.set()
        fires = dict(P.chaos.chaos.fire_counts())
        P.chaos.disarm()
        await asyncio.sleep(p["quiesce_s"])
        d = inv.delta(inv.scrape(), baseline)
        rep = gov.report()
        return dict(
            soak_census(P, ctl, sim.entity_ids),
            max_level=max_level, peak_at_close=peak_at_close, sat_close=sat_close,
            transitions=rep["transitions"],
            recovered_in_s=(round(recovered_at - closed_at, 2)
                            if recovered_at is not None else None),
            final_level=int(gov.level),
            per_level_p99={lvl: bucket_p99(b) for lvl, b in sorted(level_buckets.items())},
            metric_sheds=metric_sheds(d), shed_counts=rep["shed_counts"],
            busy_seen=busy["seen"], handovers=int(inv.sample_total(d, "handovers_total")),
            overflow=int(inv.sample_total(d, "tpu_cell_overflow_entities_total")),
            timeline=timeline, fires=fires, observer_subs=observer_subs,
            sent=sum(stats.client_sent.values()), disconnects=stats.disconnects,
            auth_retries=stats.auth_retries, settle_s=settle_s,
            global_tick_p99_s=inv.histogram_quantile(d, "channel_tick_duration", 0.99,
                                                     channel_type="GLOBAL"),
            engine=str(ctl.engine.device) if P.port else None, engine_ticks=engine_ticks[0],
            launches=({n: c - before[n] for n, c in K.launch_counts().items()}
                      if K is not None else None))
    finally:
        stop.set()
        send_stop.set()
        P.chaos.disarm()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        server_srv.close()
        client_srv.close()
        reset_gateway(P)


def overload_live_checks(r: dict, p: dict) -> list:
    """scripts/overload_soak.py's invariants, under its names, as (name,
    held, detail): one ``tick_p99_bounded_at_L<n>`` per level the poller
    saw GLOBAL ticks at."""
    steps = [t["to"] - t["from"] for t in r["transitions"]]
    # After the window closed (and a grace for the EWMA) the ladder may
    # re-brake, but never above the peak the overload itself reached.
    ups = [t for t in r["transitions"]
           if t["to"] > r["peak_at_close"] and t["t"] > r["sat_close"] + 2.0]
    sheds = r["shed_counts"]
    admission = sheds.get("admission_connection", 0)
    checks = [
        ("ladder_reached_at_least_L2", r["max_level"] > 1, r["max_level"]),
        ("ladder_moves_one_step_at_a_time", [s for s in steps if abs(s) != 1] == [], steps),
        ("release_never_exceeds_overload_peak", ups == [], ups),
        ("returned_to_L0_within_deadline",
         r["recovered_in_s"] is not None and r["final_level"] <= 1,
         (r["recovered_in_s"], r["final_level"])),
        *[(f"tick_p99_bounded_at_L{lvl}", p99 <= p["tick_p99_bounds"][lvl], p99)
          for lvl, p99 in r["per_level_p99"].items() if p99 is not None],
        ("no_lost_entity_tracking", r["lost_tracking"] == [], r["lost_tracking"]),
        ("every_entity_in_exactly_one_cell", (r["missing"], r["duped"]) == ([], []),
         (r["missing"], r["duped"])),
        ("shed_accounting_exact", r["metric_sheds"] == sheds, (r["metric_sheds"], sheds)),
        ("sheds_fired", sum(sheds.values()) > 0, sheds)]
    if p["require_update_priority"]:
        checks.append(("low_priority_updates_shed", sheds.get("update_priority", 0) > 0, sheds))
    if p["require_handover_defer"]:
        checks.append(("handover_deferred", sheds.get("handover_defer", 0) > 0, sheds))
    return checks + [
        ("busy_frames_le_admission_sheds", r["busy_seen"] <= admission,
         (r["busy_seen"], admission)),
        ("handovers_orchestrated", r["handovers"] > 0, r["handovers"])]


def ladder_line(transitions) -> str:
    """A transition list as ``L0->L1 @t s, ...``."""
    return ", ".join(f"L{frm}->L{to} @{t:g} s" for frm, to, t in transitions) or "no move"


def overload_lockstep_size(scratch: str, n_dev: Optional[int] = None, **kw) -> dict:
    """14a's size: ``overload_lockstep_params(**kw)`` and its cells config at
    MeshDevices = n_dev (default min(cards, 8)), written into ``scratch``."""
    if n_dev is None:
        n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
    p = overload_lockstep_params(**kw)
    return dict(params=p, n_dev=n_dev,
                config=cells_config(n_dev, scratch, overload_scenario(p)["config_overrides"]))


def phase_overload_lockstep(K, dev, cpu_leg: "CpuLeg") -> tuple:
    """14a: ``OverloadWorld`` on the card against a lockstep CPU leg at the
    same size (``cpu_leg.size``) in ``cpu_leg``'s child, tick for tick, both
    held to the ladder's invariants. Returns (K1/K2 launches, the kernels'
    entries on the overflow tick and the saturation tick)."""
    P = gateway_modules()
    size = cpu_leg.size
    p, n_dev = size["params"], size["n_dev"]
    t_phase = time.perf_counter()
    try:
        card, rc = run_overload_lockstep(P, dev, p, size["config"], K)
        cpu, rp = cpu_leg.result()
    finally:
        cpu_leg.close()
    check(len(card) == len(cpu), f"14a: {len(card)} card and {len(cpu)} cpu ticks")
    for t in range(len(card)):
        where = first_gateway_diff(card[t], cpu[t])
        check(where is None, f"14a tick {t}: cuda and cpu differ: {where}")
    for leg, obs, r in (("cuda", card, rc), ("cpu", cpu, rp)):
        for name, ok, detail in overload_lockstep_checks(obs, r):
            check(ok, f"14a {leg}: {name}: {str(detail)[:300]}")
        check({o["transfers"] for o in obs} == {2}, f"14a {leg}: engine transfers a tick "
                                                    f"{sorted({o['transfers'] for o in obs})}")
    n = rc["n_shards"]
    for t, o in enumerate(card):
        check(o["launches"] == {name: n for name in o["launches"]},
              f"14a tick {t}: launches {o['launches']}, not {n} each (one per shard)")
        check(o["reads"] == 2, f"14a tick {t}: {o['reads']} device reads, not 2 (the consume "
                               f"blob and the query plane's changed rows)")
    check(set(rc["kernels"]) == {"overflow", "saturation"},
          f"14a: K1/K2 held on the live tensors of {sorted(rc['kernels'])} ticks only")
    sheds, ticks = rc["shed_counts"], len(card)
    levels = [o["governor"][0] for o in card]
    print(f"14a overload lockstep: {ticks} GLOBAL ticks ({rc['seconds']:.3f} s of the fixed "
          f"clock: warmup {p['warmup_s']:g} s, saturation {p['saturation_s']:g} s, the window "
          f"closed at tick {rc['closed_at']}, L0 at tick {rc['recovered_at']}) of "
          f"config/spatial_tpu_cells_2x2.json at MeshDevices {n_dev} with CellBucket 6 "
          f"({p['entity_capacity']} slots, {p['query_capacity']} query rows), "
          f"{p['entities']} entities (storms of {p['storm_size']}), {p['clients']} clients' "
          f"forwards, {p['observers']} observers at 200 ms, the query plane on; the ladder "
          f"{ladder_line(rc['transitions'])}; ticks at L0-L3 "
          f"{[levels.count(lvl) for lvl in range(4)]}; sheds {sheds} (= overload_sheds_total); "
          f"{rc['busy_frames']} ServerBusyMessage to {rc['admitted']} late clients; overflow "
          f"{sum(o['overflow'] for o in card)} entities on "
          f"{sum(1 for o in card if o['overflow'])} ticks; handovers "
          f"{sum(len(o['handovers']) for o in card)}, deferred on "
          f"{sum(1 for o in card if o['deferred'])} ticks; chaos fires {rc['fires']}: cuda "
          f"equals the CPU leg on every tick (level, pressure, components, transitions, shed "
          f"ledger, overflow, handovers and the deferred, tables, every outbound stream); 2 "
          f"device reads and 2 engine transfers a tick; launches {rc['launches']}; phase "
          f"{time.perf_counter() - t_phase:.1f} s (card leg {rc['secs']:.1f} s, cpu leg "
          f"{rp['secs']:.1f} s in a --cpu-leg child)")
    for leg, obs in (("cuda", card), ("cpu", cpu)):
        print(f"14a on {leg}: tick (host clock) {tick_stats([o['tick_ms'] for o in obs[1:]])}")
    entries: dict = {}
    for case, ks in sorted(rc["kernels"].items()):
        for name, k in ks.items():
            entries.setdefault(name, {})[f"14a_{case}_tick"] = k
            print(f"14a {name} on the {case} tick's live tensors ({k['shape']}): exact; alone "
                  f"{k['ms']:.4f} ms (events, bare launches), plain {k['plain_ms']:.4f} ms, "
                  f"bound {k['bound_ms']:.6f} ms ({k['bound_by']})")
    return rc["launches"], entries


def phase_live_launches(r: dict, n_dev: int, what: str) -> None:
    """The engine ticked on ``cuda``, and K1 and K2 launched once per shard on
    every engine tick of a live phase."""
    check(r["engine"].startswith("cuda"), f"{what}: the engine ran on {r['engine']}")
    want = {name: n_dev * r["engine_ticks"] for name in r["launches"]}
    check(r["engine_ticks"] > 0 and r["launches"] == want,
          f"{what}: launches {r['launches']} in {r['engine_ticks']} engine ticks")


def phase_chaos_live(K, dev, n_dev: int, p: dict) -> dict:
    """14b: ``chaos_live`` on the card, held to scripts/chaos_soak.py's
    invariants and to K1/K2 once per shard on every engine tick."""
    import asyncio
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="chaos-live-")
    t_phase = time.perf_counter()
    try:
        r = asyncio.run(chaos_live(P, dev, p, scratch, n_dev, K))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name, ok, detail in chaos_live_checks(r, p):
        check(ok, f"14b: {name}: {str(detail)[:300]}")
    phase_live_launches(r, n_dev, "14b")
    lat = r["recovery_latencies"]
    print(f"14b chaos live: {p['duration_s'] - p['quiesce_s']:g} s of traffic and "
          f"{p['quiesce_s']:g} s quiesced, {p['clients']} clients at {p['msg_rate']:g} msg/s, "
          f"{p['entities']} entities (storms of {p['storm_size']} every "
          f"{p['storm_every_s']:g} s), MeshDevices {n_dev} with CellBucket 6, "
          f"{p['entity_capacity']} slots / {p['query_capacity']} query rows, the ladder on; "
          f"every invariant of the soak held; chaos fires {r['fires']}; forwards sent "
          f"{r['sent']}, received {r['received']} = drained {r['drained']}; disconnects "
          f"{r['disconnects']}, reconnects {r['reconnects']}, auth retries "
          f"{r['auth_retries']}, recovery latency max {max(lat, default=0.0):.4f} s, mean "
          f"{sum(lat) / max(len(lat), 1):.4f} s; handovers {r['handovers']}; overflow "
          f"{r['overflow']} entities; GLOBAL tick p99 {r['global_tick_p99_s']:.4f} s, "
          f"tpu_spatial_step_seconds p99 {r['device_step_p99_s']:.4f} s; the ladder's peak "
          f"L{r['peak_level']} ({r['transitions']} moves, sheds {r['sheds']}); launches "
          f"{r['launches']} in {r['engine_ticks']} engine ticks; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return r


def phase_overload_live(K, dev, n_dev: int, p: dict) -> dict:
    """14c: ``overload_live`` on the card, held to scripts/overload_soak.py's
    invariants and to K1/K2 once per shard on every engine tick."""
    import asyncio
    import itertools
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="overload-live-")
    t_phase = time.perf_counter()
    try:
        r = asyncio.run(overload_live(P, dev, p, scratch, n_dev, K))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name, ok, detail in overload_live_checks(r, p):
        check(ok, f"14c: {name}: {str(detail)[:300]}")
    phase_live_launches(r, n_dev, "14c")
    levels = [e["level"] for e in r["timeline"]]
    runs = [(lvl, len(list(g))) for lvl, g in itertools.groupby(levels)]
    print(f"14c overload live: settle {r['settle_s']:.1f} s, warmup {p['warmup_s']:g} s, "
          f"saturation {p['saturation_s']:g} s, recovery deadline {p['recover_deadline_s']:g} "
          f"s, quiesce {p['quiesce_s']:g} s; {p['clients']} busy-aware clients at "
          f"{p['msg_rate']:g} msg/s, {p['observers']} observers ({r['observer_subs']} client "
          f"subscriptions seen), {p['entities']} entities (storms of {p['storm_size']}), "
          f"MeshDevices {n_dev}, {p['entity_capacity']} slots; every invariant of the soak "
          f"held; the ladder "
          f"{ladder_line([(t['from'], t['to'], t['t']) for t in r['transitions']])}, peak "
          f"L{r['max_level']}, back to L0 {r['recovered_in_s']} s after the window closed; "
          f"level timeline (level, 250 ms samples) {runs}; GLOBAL tick p99 per level "
          + ", ".join(f"L{lvl} {v:.4f} s" if v is not None else f"L{lvl} none"
                      for lvl, v in r["per_level_p99"].items())
          + f"; sheds {r['shed_counts']} (= overload_sheds_total); ServerBusyMessage seen "
          f"{r['busy_seen']}; handovers {r['handovers']}; overflow {r['overflow']} entities; "
          f"chaos fires {r['fires']}; launches {r['launches']} in {r['engine_ticks']} engine "
          f"ticks; phase {time.perf_counter() - t_phase:.1f} s")
    return r


def phase_chaos_overload(K, dev, cpu_leg: "CpuLeg") -> tuple:
    """14a (its CPU leg in ``cpu_leg``'s child, ``CpuLeg("14a")``) and 14b-14c
    on the cells world at MeshDevices = min(cards, 8) and the gateway's
    tables. Returns ({path: launches}, {kernel: {case: entry}})."""
    n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
    t_phase = time.perf_counter()
    launches, entries = phase_overload_lockstep(K, dev, cpu_leg)
    chaos = phase_chaos_live(K, dev, n_dev, chaos_params(duration_s=60.0, **GATEWAY_CAPACITIES))
    overload = phase_overload_live(K, dev, n_dev, overload_params(
        warmup_s=6.0, saturation_s=20.0, quiesce_s=4.0, **GATEWAY_CAPACITIES))
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return ({"overload_lockstep": launches, "chaos_live": chaos["launches"],
             "overload_live": overload["launches"]}, entries)


# ---- phase 15: the fleet's device side, and the federation soak's live fleet ----

FLEET_SEED = 20260803  # scripts/federation_soak.py's and scripts/global_soak.py's seed



# 15a's ticks of a fixed 50 ms clock: one control epoch (250 ms) is 5 ticks, the
# plane's timeout sweep (100 ms) 2.
FLEET_TICK_S = 0.05
FLEET_EPOCH_TICKS = 5
FLEET_SWEEP_TICKS = 2
# The stub trunks' directory ports: written into the shard directory, never opened.
FLEET_PORTS = dict(a_trunk=17001, a_client=17002, b_trunk=17003, b_client=17004,
                   c_trunk=17005, c_client=17006)
# The ticks each event of 15a's script starts on.
FLEET_AT = dict(burst=10, refusal=25, herd=40, sever=50, trunk_up=56, silent=70)
FLEET_RETRY_AFTER_MS = 300  # stub b's busy refusal: FedSoakParams.retry_after_ms
FLEET_CELLS = {"a": (0, 1, 6, 7, 12, 13, 18, 19), "b": (2, 3, 8, 9, 14, 15, 20, 21),
               "c": (4, 5, 10, 11, 16, 17, 22, 23)}  # WORLD_3's blocks, cell indices
FLEET_SENSOR_KEY = 1 << 20  # stub c's sensor rows: keys apart from a's own


def fleet_size(**kw) -> dict:
    """15a's sizes: the gateway's tables (1<<17 entity slots, 4,096 query
    rows), scripts/federation_soak.py's acceptance run (FedSoakParams
    96 / 24 / 10 / 24 / 16) for the entities and bursts, 64 sim agents."""
    size = dict(entity_capacity=1 << 17, query_capacity=4096, entities=96, agents=64,
                sensors=8, followers=4, burst=24, burst_agents=8, refusal=10, herd=16,
                herd_agents=6, sever=24, adopt=14, adopt_sensors=4, claimed=2, ticks=150,
                deadline_s=GATEWAY_DEADLINE_S)
    size.update(kw)
    return size


class TrunkTap:
    """A stub trunk link to one scripted peer (the surface the federation and
    control planes touch): ``alive`` while the peer's trunk is up, every
    send kept as (msg_type, bytes, message class)."""

    def __init__(self, peer: str):
        self.peer_id = peer
        self.alive = True
        self.rtt_ms = 1.0
        self.sent: list = []

    def send(self, msg_type, msg) -> bool:
        if not self.alive:
            return False
        self.sent.append((int(msg_type), msg.SerializeToString(deterministic=True), type(msg)))
        return True


class StubPeer:
    """A scripted peer gateway of 15a behind a ``TrunkTap``, the same for
    both packages (it builds its messages from the leg's ``control_pb2``):
    it reads what gateway a sent it and answers through a's own trunk
    dispatch (``plane._on_trunk_message``), keeping the census of the
    entities it holds. ``mode``: ``ack`` commits every prepare, ``busy``
    refuses with the L3 ServerBusyMessage, ``cut`` applies without acking
    (the trunk is about to be cut)."""

    def __init__(self, world, gw: str):
        self.w, self.P, self.gw = world, world.P, gw
        self.link = world.taps.links[gw]
        self.census: set = set()
        self.applied: dict = {}   # (initiator, batch id) -> ids applied here
        self.outbound: dict = {}  # our prepares' batch id -> ids
        self.read = 0
        self.mode = "ack"
        self.busy = 0
        self.claims: list = []
        self.directory_version = 0
        self.batch = 0

    def deliver(self, msg_type, msg) -> None:
        self.w.plane._on_trunk_message(self.gw, int(msg_type), msg)

    def inbox(self) -> list:
        new = self.link.sent[self.read:]
        self.read = len(self.link.sent)
        return [(t, cls.FromString(b)) for t, b, cls in new]

    def answer(self) -> None:
        """Read and answer everything gateway a sent since the last call."""
        P = self.P
        MT, pb = P.types.MessageType, P.control_pb2
        for t, msg in self.inbox():
            if t == MT.TRUNK_HANDOVER_PREPARE:
                ids = [e.entityId for e in msg.entities]
                if self.mode == "busy":
                    self.busy += 1
                    ack = pb.TrunkHandoverAckMessage(batchId=msg.batchId, committed=False,
                                                     reason="overload", traceId=msg.traceId)
                    ack.busy.CopyFrom(pb.ServerBusyMessage(
                        reason="federation", retryAfterMs=FLEET_RETRY_AFTER_MS, overloadLevel=3))
                    self.deliver(MT.TRUNK_HANDOVER_ACK, ack)
                    continue
                self.census.update(ids)
                self.applied[("a", msg.batchId)] = ids
                if self.mode == "ack":
                    self.deliver(MT.TRUNK_HANDOVER_ACK, pb.TrunkHandoverAckMessage(
                        batchId=msg.batchId, committed=True, traceId=msg.traceId))
            elif t == MT.TRUNK_HANDOVER_ACK:
                ids = self.outbound.pop(msg.batchId, [])
                if msg.committed:
                    self.census.difference_update(ids)
            elif t == MT.TRUNK_ABORT_NOTICE:
                for bid in msg.batchIds:
                    self.census.difference_update(
                        self.applied.pop((msg.initiator or "a", bid), []))
            elif t == MT.TRUNK_DIRECTORY_UPDATE:
                self.directory_version = max(self.directory_version, msg.version)
            elif t == MT.TRUNK_ADOPT_QUERY:
                self.claims = sorted(e for e in msg.entityIds if e in self.census)
                self.deliver(MT.TRUNK_ADOPT_CLAIMS, pb.TrunkAdoptClaimsMessage(
                    deadGateway=msg.deadGateway, gatewayId=self.gw, entityIds=self.claims,
                    seq=msg.seq))

    def load_report(self, epoch: int, entities: int) -> None:
        self.deliver(self.P.types.MessageType.TRUNK_LOAD_REPORT,
                     self.P.control_pb2.TrunkLoadReportMessage(
                         gatewayId=self.gw, epoch=epoch, entities=entities, cells=8,
                         trunkRttMs=1.0, directoryVersion=self.directory_version))

    def prepare(self, src: int, dst: int, rows: list) -> None:
        """One trunked handover batch from this peer into gateway a's cell
        ``dst``: ``rows`` are (entity id, x, z)."""
        P = self.P
        self.batch += 1
        bid = 9000 + self.batch
        msg = P.control_pb2.TrunkHandoverPrepareMessage(
            batchId=bid, srcChannelId=src, dstChannelId=dst, traceId=f"{self.gw}-herd-{self.batch}")
        for i, (eid, x, z) in enumerate(rows):
            e = msg.entities.add(entityId=eid, txnId=bid + i)
            e.data.CopyFrom(P.anyutil.pack_any(sim_entity_data(P, eid, x, z)))
        self.outbound[bid] = [eid for eid, _, _ in rows]
        self.deliver(P.types.MessageType.TRUNK_HANDOVER_PREPARE, msg)


def sim_entity_data(P, eid: int, x: float, z: float):
    """An entity channel's SimEntityChannelData at (x, z)."""
    d = P.sim_pb2.SimEntityChannelData()
    d.state.entityId = eid
    d.state.transform.position.x = x
    d.state.transform.position.z = z
    return d


def fleet_replica(P, seq: int, cells: dict, txns: list, sensors: list):
    """Stub c's TrunkShardEpochMessage: ``cells`` {cell channel: [(id, x, z)]},
    ``txns`` [(batch id, src, dst, peer, [(id, x, z)])], ``sensors`` the
    query plane's (key, scope, name, kind, params, spot dists) rows."""
    pb = P.control_pb2
    msg = pb.TrunkShardEpochMessage(epochSeq=seq)
    for cid, rows in sorted(cells.items()):
        data = P.sim_pb2.SimSpatialChannelData()
        for eid, x, z in rows:
            st = data.entities[eid]
            st.entityId = eid
            st.transform.position.x = x
            st.transform.position.z = z
        rc = msg.cells.add(channelId=cid)
        rc.data.CopyFrom(P.anyutil.pack_any(data))
        rc.entityIds.extend(sorted(eid for eid, _, _ in rows))
    for bid, src, dst, peer, rows in txns:
        txn = msg.txns.add(batchId=bid, srcChannelId=src, dstChannelId=dst, peer=peer)
        for i, (eid, x, z) in enumerate(rows):
            e = txn.entities.add(entityId=eid, txnId=bid + i)
            e.data.CopyFrom(P.anyutil.pack_any(sim_entity_data(P, eid, x, z)))
    for key, scope, name, kind, params, spots in sensors:
        msg.queries.add(key=key, scope=scope, name=name, kind=kind, params=params,
                        spotDists=spots)
    return msg


def fed_timeouts(plane) -> None:
    """One pass of the federation plane's ``_timeout_loop`` body (its
    100 ms sweep: expired batches abort, parked crossings re-offer, abort
    notices re-flush, unacked stagings redirect), driven on the fixed
    clock instead of by the loop's sleep."""
    now = time.monotonic()
    expired = [b for b in plane._pending.values() if now > b.deadline]
    if expired:
        def expire(batches=expired):
            for b in batches:
                if b.batch_id in plane._pending:
                    plane._abort_batch(b, "ack timeout")

        plane._in_global_tick(expire)
    if plane._parked:
        plane._in_global_tick(lambda: plane._reoffer_parked())
    resend = sys.modules[type(plane).__module__].ABORT_NOTICE_RESEND_S
    for peer, notices in list(plane._abort_notices.items()):
        if not notices or now - plane._notices_flushed_at.get(peer, 0.0) < resend:
            continue
        link = plane.link_to(peer)
        if link is not None:
            plane._flush_abort_notices(peer, link)
    for pit, pending in list(plane._pending_redirects.items()):
        if now <= pending[5]:
            continue
        del plane._pending_redirects[pit]
        conn, entity_id, dst_cid, peer, token, _d, trace = pending
        plane._send_redirect(conn, peer, entity_id, dst_cid, token, staged=False, trace=trace)



class FleetWorld(GatewayWorld):
    """15a: gateway "a" of scripts/global_soak.py's three-gateway world
    in-process on a fixed clock, through one package's modules ``P``:
    WORLD_3's geometry on the device controller (``TPUSpatialController``,
    the port's alias of ``GPUSpatialController``) with the sim plane and the
    query plane on, the global soak's directory (``fed_config3``), boot pins
    and control-plane settings, the device guard on; "a" is the leader. The
    peers b and c are ``StubPeer``s behind ``TrunkTap`` links; the plane's
    timeout sweep and the control epoch run on the fixed clock
    (``fed_timeouts``, ``_epoch_tick``). The script (``FLEET_AT``): boot (the
    entities in a's block, the agents, sensors of every kind, followers);
    an outbound burst east across x = -50 committed by b; a burst b refuses
    at L3; b's inbound herd (agents among them); a burst whose trunk is cut
    mid-flight and re-offered on trunk up; c's shard epochs (its cells'
    entities, two in-flight txns, sensor rows), its silence, a's death
    declaration, b's census claims and a's adoption. Records per tick the
    handovers, the trunk messages a sent, the tables, the placement ledger,
    the engine's slots, cells and counts, the agents and sim columns, the
    changed query rows, every ledger and every outbound stream."""

    def __init__(self, P, dev: torch.device, clock, size: dict, config: str, K=None):
        from random import Random

        self.P, self.dev, self.clock, self.size, self.K = P, dev, clock, size, K
        reset_gateway(P)
        P.federation.reset_federation()
        P.failover.reset_failover()
        P.tracing._trace_counter = itertools.count(1)  # trace ids ride the trunk messages
        gp = GlobalSoakParams()
        fed_pins(P, FedSoakParams(heartbeat_ms=gp.heartbeat_ms,
                                  trunk_timeout_ms=gp.trunk_timeout_ms,
                                  handover_timeout_ms=gp.handover_timeout_ms,
                                  global_tick_ms=gp.global_tick_ms))
        global_settings_hook(gp)(P.settings.global_settings)
        s = P.settings.global_settings
        if P.port:
            s.spatial_device = dev.type
        s.tpu_entity_capacity = size["entity_capacity"]
        s.tpu_query_capacity = size["query_capacity"]
        s.sim_enabled = True
        s.sim_agents = size["agents"]
        s.device_guard_enabled = True
        s.device_step_deadline_s = size["deadline_s"]
        P.message.init_message_map()
        P.channel.init_channels()
        P.sim_models.register_sim_types()
        P.controller.init_spatial_controller(config)
        ctl = self.ctl = P.controller.get_spatial_controller()
        self.eng = ctl.engine
        if P.port:
            check(self.eng.device.type == dev.type, f"the engine is on {self.eng.device}, not {dev}")
        fed = P.federation
        fed.init_federation(fed_config3(FLEET_PORTS), "a", ctl)
        self.plane, self.control, self.directory = fed.plane, fed.control, fed.directory
        # The stub trunk manager: ``plane.link_to`` reads its ``links``.
        self.taps = NS(links={p: TrunkTap(p) for p in ("b", "c")}, stop=lambda: None)
        self.plane.manager = self.taps
        self.plane.active = True
        self.control.plane, self.control.active = self.plane, True  # the epoch runs on the clock
        self.conns: list = []
        self.handovers, self.step_ms, self.rebuild_ms = [], [], []
        self.engine_ticks = 0
        self._wrap()
        self._servers()
        self.gch = P.channel.get_global_channel()
        self.peers = {gw: StubPeer(self, gw) for gw in ("b", "c")}
        for gw in ("b", "c"):
            self.plane._on_trunk_up(gw, self.taps.links[gw])
        self.rng = Random(FLEET_SEED ^ 0xF1)
        self.start = s.spatial_channel_id_start
        self.estart = s.entity_channel_id_start
        self.agent_base = self.estart + P.sim_plane.AGENT_ID_OFFSET
        self._entities()
        self._queries()
        self._peer_worlds()
        self.events: list = []   # (name, held, detail)
        self.kernels: dict = {}
        self.adopted_at = None
        self.columns: list = []  # with size["columns"]: each tick's agent rows
        self.metrics0 = P.invariants.scrape()

    _wrap = SoakWorld._wrap

    # ---- boot ------------------------------------------------------------

    def _servers(self) -> None:
        P, ctl = self.P, self.ctl
        master = self.conn(1, "SERVER")
        gch = P.channel.get_global_channel()
        gch.set_owner(master)
        P.sub.subscribe_to_channel(master, gch, None)
        server = self.conn(2, "SERVER")
        ctx = P.message.MessageContext(msg_type=P.types.MessageType.CREATE_CHANNEL,
                                       msg=P.control_pb2.CreateChannelMessage(), connection=server)
        for ch in ctl.create_channels(ctx):
            P.sub.subscribe_to_channel(server, ch, None)
        self.local_cells = sorted(c for c, ch in P.channel.all_channels().items()
                                  if ch.channel_type == P.types.ChannelType.SPATIAL)
        want = [self.P.settings.global_settings.spatial_channel_id_start + i
                for i in FLEET_CELLS["a"]]
        check(self.local_cells == want, f"a's local cells {[hex(c) for c in self.local_cells]}")

    def cell_of(self, x: float, z: float) -> int:
        return self.ctl.get_channel_id(self.P.controller.SpatialInfo(x, 0, z))

    def _entities(self) -> None:
        """The global soak's entities in a's block (``FedSim``), tracked on
        the device from birth."""
        P, ctl = self.P, self.ctl
        sim = FedSim(P, ctl, self.rng)
        sim.create_entities(self.size["entities"], *GLOBAL_XR["a"], *GLOBAL_ZR,
                            base=GLOBAL_BASE["a"])
        self.entity_ids = sim.entity_ids
        self.positions: dict = {}
        for eid in self.entity_ids:
            pos = P.channel.get_channel(eid).get_data_message().state.transform.position
            ctl.track_entity(eid, P.controller.SpatialInfo(pos.x, 0, pos.z))

    def _queries(self) -> None:
        """Sensors of every kind over a's block, followers on its entities,
        and clients subscribed to its cells."""
        P, ctl, ops, rng = self.P, self.ctl, self.P.ops, self.rng
        (x0, x1), (z0, z1) = GLOBAL_XR["a"], GLOBAL_ZR
        kinds = (ops.AOI_BOX, ops.AOI_SPHERE, ops.AOI_CONE, ops.AOI_SPOTS)
        for i in range(self.size["sensors"]):
            kind = kinds[i % 4]
            cx, cz = rng.uniform(x0, x1), rng.uniform(z0, z1)
            if kind == ops.AOI_SPOTS:
                ctl.register_sensor(f"a-sensor{i}", kind=kind, spots=[
                    (cx, cz), (rng.uniform(x0, x1), rng.uniform(z0, z1))], dists=[0, 1])
            else:
                ctl.register_sensor(f"a-sensor{i}", kind=kind, center=(cx, cz),
                                    extent=(rng.uniform(40, 90), rng.uniform(40, 90)),
                                    direction=(1.0, 0.0), angle=0.7)
        for i in range(self.size["followers"]):
            client = self.conn(1000 + i, "CLIENT")
            eid = self.entity_ids[(7 * i + 3) % len(self.entity_ids)]
            ctl.register_follow_interest(client, eid, ops.AOI_SPHERE, extent=(60.0, 0.0))
        for i in range(4):
            client = self.conn(2000 + i, "CLIENT")
            for cid in self.local_cells[2 * i:2 * i + 2]:
                P.sub.subscribe_to_channel(client, P.channel.get_channel(cid),
                                           P.control_pb2.ChannelSubscriptionOptions(
                                               fanOutIntervalMs=50))

    def _peer_worlds(self) -> None:
        """Stub b's and stub c's holdings: b's herd (humans and agents in the
        agent range), c's cells' entities (the first ``claimed`` of them
        already on b: b claims them in the census), two in-flight txns of
        c's (one toward b, one a local hop), and c's sensor rows."""
        P, rng, size = self.P, self.rng, self.size
        start, estart = self.start, self.estart
        b, c = self.peers["b"], self.peers["c"]
        n_agents = size["herd_agents"]
        self.herd_ids = ([estart + 1 + GLOBAL_BASE["b"] + i for i in range(size["herd"] - n_agents)]
                         + [self.agent_base + GLOBAL_BASE["b"] + i for i in range(n_agents)])
        b.census.update(self.herd_ids)
        (x0, x1), (z0, z1) = GLOBAL_XR["c"], GLOBAL_ZR
        self.c_cells: dict = {}
        c_ids = [estart + 1 + GLOBAL_BASE["c"] + i for i in range(size["adopt"] + 2)]
        rows = [(eid, rng.uniform(x0, x1), rng.uniform(z0, z1)) for eid in c_ids]
        for eid, x, z in rows[: size["adopt"]]:
            self.c_cells.setdefault(self.cell_of(x, z), []).append((eid, x, z))
        self.claimed = c_ids[: size["claimed"]]
        b.census.update(self.claimed)
        tx_b, tx_local = rows[size["adopt"]], rows[size["adopt"] + 1]
        b_cell = start + FLEET_CELLS["b"][0]
        c_src = self.cell_of(tx_local[1], tx_local[2])
        c_dst = next(start + i for i in FLEET_CELLS["c"] if start + i != c_src)
        self.c_txns = [(5001, self.cell_of(tx_b[1], tx_b[2]), b_cell, "b", [tx_b]),
                       (5002, c_src, c_dst, "c", [tx_local])]
        self.c_ids = c_ids
        ops, qp = P.ops, P.queryplane
        kinds = (ops.AOI_BOX, ops.AOI_SPHERE, ops.AOI_CONE, ops.AOI_SPOTS)
        self.c_sensors = []
        for i in range(size["adopt_sensors"]):
            kind = kinds[i % 4]
            cx, cz = rng.uniform(x0, x1), rng.uniform(z0, z1)
            spots = [(cx, cz), (rng.uniform(x0, x1), rng.uniform(z0, z1))] \
                if kind == ops.AOI_SPOTS else None
            self.c_sensors.append((FLEET_SENSOR_KEY + i, "sensor", f"c-sensor{i}", int(kind),
                                   qp.pack_params((cx, cz), (70.0, 50.0), (0.0, 1.0), 0.6, spots),
                                   [0, 2] if spots else []))
        c.census.update(c_ids[size["claimed"]:])

    # ---- the script ------------------------------------------------------

    def backed_agents(self) -> list:
        """Channel-backed agents in a's block, by id."""
        P, ctl = self.P, self.ctl
        out = []
        for eid in sorted(ctl.simplane.authority._backed):
            ch = P.channel.get_channel(eid)
            if ch is not None and self.ctl._data_cell.get(eid) in self.local_cells:
                out.append(eid)
        return out

    def east(self, n: int, n_agents: int) -> list:
        """``n`` of a's live entities (``n_agents`` of them agents) moved just
        east of x = -50, into b's block."""
        P = self.P
        humans = [e for e in self.entity_ids if P.channel.get_channel(e) is not None
                  and e not in self.plane._parked][: n - n_agents]
        agents = self.backed_agents()[:n_agents]
        check(len(humans) + len(agents) == n, f"15a: {len(humans)} + {len(agents)} of {n} to move")
        for eid in humans + agents:
            self.move(eid, -50.0 + self.rng.uniform(1.0, 6.0), self.rng.uniform(*GLOBAL_ZR))
        return humans + agents

    def expect(self, name: str, ok, detail="") -> None:
        self.events.append((name, bool(ok), str(detail)[:300]))

    def drive(self, t: int) -> None:
        at, size = FLEET_AT, self.size
        b, c = self.peers["b"], self.peers["c"]
        tap_b, tap_c = self.taps.links["b"], self.taps.links["c"]
        MT = self.P.types.MessageType
        b.answer()
        if tap_c.alive:
            c.answer()
        if t == at["sever"] + 1:  # the cut: b applied the burst, its acks are lost
            tap_b.alive = False
            self.plane._on_trunk_down("b", tap_b)
        if t == at["trunk_up"]:
            tap_b.alive, b.mode = True, "ack"
            self.plane._on_trunk_up("b", tap_b)
        if t == at["silent"]:  # c's process dies: what it held lives on only in its replicas
            tap_c.alive = False
            c.census.clear()
            self.plane._on_trunk_down("c", tap_c)
        if t % FLEET_EPOCH_TICKS == 0:
            # The peers report a's own last load (b one more): the fleet stays
            # balanced, so the leader plans no migration, and a, the least
            # loaded survivor, adopts c's shard.
            epoch = t // FLEET_EPOCH_TICKS + 1
            load = self.control.vectors.get("a", {}).get("entities", 0)
            if tap_b.alive:
                b.load_report(epoch, load + 1)
            if tap_c.alive:
                c.load_report(epoch, load)
                c.deliver(MT.TRUNK_SHARD_EPOCH, fleet_replica(self.P, epoch, self.c_cells,
                                                              self.c_txns, self.c_sensors))
            self.plane._in_global_tick(self.control._epoch_tick)
        if t % FLEET_SWEEP_TICKS == 0:
            fed_timeouts(self.plane)
        if t == at["burst"]:
            self.burst = self.east(size["burst"], size["burst_agents"])
        elif t == at["refusal"]:
            b.mode = "busy"
            self.refused = self.east(size["refusal"], 0)
        elif t == at["refusal"] + 2:
            b.mode = "ack"
        elif t == at["herd"]:
            half = len(self.herd_ids) // 2
            for k, ids in enumerate((self.herd_ids[:half], self.herd_ids[half:])):
                dst = self.local_cells[1 + 2 * k]
                src = self.start + FLEET_CELLS["b"][2 * k]
                cx, cz = self.centre(dst)
                b.prepare(src, dst, [(e, cx + 3.0, cz - 2.0) for e in ids])
        elif t == at["sever"]:
            b.mode = "cut"
            self.severed = self.east(size["sever"], 0)

    def centre(self, cid: int) -> tuple:
        info = self.ctl._cell_center(cid - self.start)
        return info.x, info.z

    # ---- the six events --------------------------------------------------

    def check_events(self, t: int) -> None:
        at, P, eng, ctl = FLEET_AT, self.P, self.eng, self.ctl
        b = self.peers["b"]
        plane, sim = self.plane, ctl.simplane
        if t == at["burst"] + 3:
            gone = [e for e in self.burst if eng.slot_of_entity(e) is None
                    and P.channel.get_channel(e) is None and e in b.census]
            self.expect("outbound_burst_untracked_after_commit", gone == self.burst,
                        (len(gone), len(self.burst)))
            self.expect("agents_departed_with_the_burst",
                        sim.ledgers.get("agents_departed", 0) == self.size["burst_agents"],
                        sim.ledgers)
        if t == at["refusal"] + 2:
            back = [e for e in self.refused if eng.slot_of_entity(e) is not None
                    and e in plane._parked and self.in_cell(e, ctl._data_cell.get(e))]
            self.expect("refused_burst_back_at_its_source", back == self.refused
                        and plane.busy_frames == b.busy > 0
                        and plane.ledger.get("refused", 0) == b.busy,
                        (len(back), plane.busy_frames, b.busy, plane.ledger))
        if t == at["herd"] + 2:
            centred = [e for e in self.herd_ids if eng.slot_of_entity(e) is not None
                       and tuple(eng._positions[eng.slot_of_entity(e)][[0, 2]])
                       == self.centre(ctl._data_cell.get(e))
                       and self.in_cell(e, ctl._data_cell.get(e))]
            agents = [e for e in self.herd_ids if e >= self.agent_base]
            self.expect("inbound_herd_tracked_at_cell_centres", centred == self.herd_ids,
                        (len(centred), len(self.herd_ids)))
            self.expect("inbound_agents_reflagged",
                        all(eng.is_agent(e) for e in agents)
                        and sim.ledgers.get("agents_adopted", 0) == len(agents), sim.ledgers)
            self.kernels_at("herd")
        if t == at["trunk_up"] - 1:
            back = [e for e in self.severed if e in plane._parked
                    and self.in_cell(e, ctl._data_cell.get(e))]
            to_b = [b.batch_id for b in plane._pending.values() if b.peer == "b"]
            self.expect("severed_burst_aborted_and_restored", back == self.severed and not to_b,
                        (len(back), len(self.severed), to_b))
        if t == at["trunk_up"] + 4:
            done = [e for e in self.severed + self.refused if e in b.census
                    and P.channel.get_channel(e) is None]
            self.expect("parked_crossings_reoffered_and_committed",
                        done == self.severed + self.refused
                        and plane.ledger.get("reconciled", 0) == 0
                        and not plane._parked and not plane._pending,
                        (len(done), plane.ledger))
        if self.control.adoptions and self.adopted_at is None:
            self.adopted_at = t
        elif self.adopted_at == t - 1:  # c's sensor rows reach the card with this tick's upload
            self.kernels_at("adoption")

    def in_cell(self, eid: int, cid) -> bool:
        ch = self.P.channel.get_channel(cid) if cid is not None else None
        return ch is not None and eid in ch.get_data_message().entities

    def kernels_at(self, case: str) -> None:
        eng, K = self.eng, self.K
        if K is not None:
            self.kernels[case] = soak_live_kernels(K, eng.grid, eng._d_positions, eng._d_valid,
                                                   eng._d_queries)
        else:
            self.kernels[case] = None

    def adoption_checks(self) -> None:
        """The dead peer's adoption, after the run: c declared dead by the
        leader after its miss window, a the adopter, c's cells created
        here, c's entities (but those b claimed) tracked at their cells'
        centres and placed, c's sensor rows on a's query plane."""
        P, eng, ctl, control = self.P, self.eng, self.ctl, self.control
        size = self.size
        self.expect("c_declared_dead_and_adopted_here",
                    control.dead == {"c"} and control.deaths == 1 and control.adoptions == 1,
                    (control.dead, control.deaths, control.adoptions))
        cells = [self.start + i for i in FLEET_CELLS["c"]]
        self.expect("c_cells_hosted_here", all(P.channel.get_channel(c) is not None
                                               for c in cells)
                    and all(self.directory.is_local_cell(c) for c in cells), cells)
        adopted = [e for e in self.c_ids if e not in self.claimed]
        placed = [e for e in adopted if eng.slot_of_entity(e) is not None
                  and self.in_cell(e, ctl._data_cell.get(e))]
        self.expect("c_entities_adopted_and_tracked", placed == adopted, (len(placed), len(adopted)))
        self.expect("claimed_ids_not_recreated",
                    all(P.channel.get_channel(e) is None and eng.slot_of_entity(e) is None
                        for e in self.claimed) and self.peers["b"].claims == self.claimed,
                    (self.claimed, self.peers["b"].claims))
        keys = set(ctl.queryplane._entries)
        self.expect("c_sensor_rows_restored",
                    {k for k, *_ in self.c_sensors} <= keys
                    and control.counters.get("queries_adopted", 0) == size["adopt_sensors"],
                    (sorted(keys)[-6:], control.counters))

    # ---- one tick ----------------------------------------------------------

    def tick(self, t: int) -> dict:
        P, eng, K, ctl = self.P, self.eng, self.K, self.ctl
        self.clock.advance(FLEET_TICK_S)
        self.drive(t)
        now = time.monotonic_ns()
        chans = P.channel.all_channels()
        cuda = self.dev.type == "cuda"
        crossings, ran, steps = len(self.handovers), self.engine_ticks, len(self.step_ms)
        sent0 = {gw: len(tap.sent) for gw, tap in self.taps.links.items()}
        before = K.launch_counts() if K is not None else None
        entity_channels = [ch for cid, ch in sorted(chans.items()) if cid >= self.estart]
        spatial = [ch for cid, ch in sorted(chans.items())
                   if ch.channel_type == P.types.ChannelType.SPATIAL]
        sync(self.dev)
        eng.last_result = None
        with (Reads() if cuda else contextlib.nullcontext()) as reads:
            t0 = time.perf_counter()
            for ch in entity_channels:
                ch.tick_once(now)
            self.gch.tick_once(now)
            for ch in spatial:
                ch.tick_once(now)
            t1 = time.perf_counter()
        result = eng.last_result
        obs = dict(handovers=[r for rows in self.handovers[crossings:] for r in rows],
                   ran=self.engine_ticks - ran, served=result is not None,
                   tick_ms=(t1 - t0) * 1e3,
                   step_ms=self.step_ms[steps] if len(self.step_ms) > steps else None,
                   reads=reads.count if cuda else None)
        obs.update(self.observe(result, sent0))
        if K is not None:
            obs["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
        if self.size.get("columns"):
            slots = np.sort(eng.agent_slots())
            self.columns.append([host(c)[slots] for c in (eng._d_positions, eng._d_vel,
                                                          eng._d_sim_state, eng._d_sim_target)])
        self.check_events(t)
        return obs

    def observe(self, result, sent0: dict) -> dict:
        """Digests of what the tick left: tables, the placement ledger, the
        engine's slots, committed cells, validity and counts, the agents and
        sim columns, the changed query rows, the trunk messages a sent, the
        ledgers and the peers' holdings."""
        P, eng, ctl = self.P, self.eng, self.ctl
        tables = hashlib.sha256()
        for cid, ch in sorted(P.channel.all_channels().items()):
            if ch.channel_type == P.types.ChannelType.SPATIAL:
                tables.update(np.array([cid], np.int64).tobytes())
                tables.update(ch.get_data_message().SerializeToString(deterministic=True))
        q = counts = None
        census = False
        if result is not None:
            count, rows = eng.query_changed_rows(result)
            q = (count, digest([rows[: min(count, len(rows))]])[0])
            census = "sim_census" in result
            counts = digest([np.asarray(eng.consume(result)[2] if hasattr(eng, "consume")
                                        else result["cell_counts"])])[0]
        slots = sorted(eng._slot_of_entity.items())
        engine = digest([np.asarray(slots, np.int64).reshape(-1), host(eng._d_cell),
                         host(eng._d_valid), eng._agent_mask])
        sim = digest([host(t) for t in (eng._d_positions, eng._d_vel, eng._d_sim_state,
                                              eng._d_sim_target)]) if eng._d_vel is not None else None
        trunk = {gw: [(tp, hashlib.sha256(b).hexdigest()[:16]) for tp, b, _ in tap.sent[sent0[gw]:]]
                 for gw, tap in self.taps.links.items()}
        qp = ctl.queryplane
        return dict(
            tables=tables.hexdigest(), q=q, census=census,
            counts=counts, engine=engine, sim=sim,
            placement=digest([np.asarray(sorted(ctl._data_cell.items()), np.int64).reshape(-1)])[0],
            agents=(eng.agent_count(), sorted(ctl.simplane.authority._backed)),
            trunk=trunk,
            ledgers=(sorted(self.plane.ledger.items()), self.plane.busy_frames,
                     sorted(self.control.ledger.items()), sorted(self.control.counters.items()),
                     self.control.adoptions, self.control.deaths, sorted(self.control.dead),
                     sorted(ctl.simplane.ledgers.items()),
                     sorted(ctl.simplane.authority.ledgers.items()),
                     sorted(qp.ledgers.items()), sorted(P.failover.journal.counts.items())),
            peers={gw: sorted(p.census) for gw, p in self.peers.items()},
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns})

    def run(self) -> list:
        obs = [self.tick(t) for t in range(self.size["ticks"])]
        self.adoption_checks()
        return obs

    def report(self) -> dict:
        """The books at the end: the census across a, stub b and stub c,
        each ledger against its metric."""
        P, ctl = self.P, self.ctl
        inv = P.invariants
        d = inv.delta(inv.scrape(), self.metrics0)
        fed_metric = {dict(labels)["result"]: int(v) for (name, labels), v in d.items()
                      if name == "federation_handover_total" and v}
        placed: dict = {}
        for cid, ch in P.channel.all_channels().items():
            if ch.channel_type == P.types.ChannelType.SPATIAL:
                for eid in ch.get_data_message().entities:
                    placed.setdefault(eid, []).append(("a", cid))
        for gw, peer in self.peers.items():
            for eid in peer.census:
                placed.setdefault(eid, []).append((gw, 0))
        expected = set(self.entity_ids) | set(self.herd_ids) | set(self.c_ids)
        expected |= {e for e in self.burst}
        ledger = {k: v for k, v in self.plane.ledger.items() if k not in ("redirects", "staged")}
        return dict(
            lost=sorted(e for e in expected if e not in placed),
            duplicated={e: w for e, w in placed.items() if len(w) > 1},
            fed_ledger=ledger, fed_metric=fed_metric,
            adoptions=(self.control.adoptions,
                       int(inv.sample_total(d, "gateway_adoptions_total"))),
            deaths=(self.control.deaths, int(inv.sample_total(d, "gateway_deaths_total"))),
            ledger=dict(self.plane.ledger), control=self.control.report()["counters"],
            sim=dict(ctl.simplane.ledgers), journal=dict(P.failover.journal.counts),
            in_flight=P.failover.journal.in_flight_count(),
            pending=len(self.plane._pending), parked=len(self.plane._parked),
            adopted_at=self.adopted_at, kernels=self.kernels,
            engine_ticks=self.engine_ticks, local_cells=len(self.local_cells))

    def close(self) -> None:
        self.P.federation.reset_federation()
        self._unwrap()
        reset_gateway(self.P)



def fleet_config(scratch: str) -> str:
    """WORLD_3 on the device controller, as a spatial config file."""
    import os

    path = os.path.join(scratch, "fleet_world3.json")
    with open(path, "w") as f:
        json.dump(dict(WORLD_3, SpatialControllerType="TPUSpatialController"), f)
    return path


def run_fleet_leg(P, dev: torch.device, size: dict, scratch: str, K=None) -> tuple:
    """One leg of 15a: (per-tick observations, report with the six events'
    checks and, with ``K``, the kernels on the live tensors)."""
    t_leg = time.perf_counter()
    with FixedClock() as clock:
        world = FleetWorld(P, dev, clock, size, fleet_config(scratch), K)
        if K is not None:
            K.reset_launch_counts()
        obs = world.run()
        report = world.report()
        report["events"] = list(world.events)
        report["columns"] = world.columns
        report["launches"] = K.launch_counts() if K is not None else None
        world.close()
        del world
    report["secs"] = time.perf_counter() - t_leg
    return obs, report


def fleet_checks(obs: list, r: dict) -> list:
    """15a's books of one leg, as (name, held, detail): the six events, the
    census across a, stub b and stub c (zero lost, zero duplicated), each
    ledger equal to its metric, nothing left in flight."""
    return list(r["events"]) + [
        ("census_zero_lost", r["lost"] == [], r["lost"]),
        ("census_zero_duplicated", r["duplicated"] == {}, r["duplicated"]),
        ("federation_ledger_equals_metric", r["fed_ledger"] == r["fed_metric"],
         (r["fed_ledger"], r["fed_metric"])),
        ("adoptions_equal_metric", r["adoptions"][0] == r["adoptions"][1] == 1, r["adoptions"]),
        ("deaths_equal_metric", r["deaths"][0] == r["deaths"][1] == 1, r["deaths"]),
        ("journal_balanced", r["journal"].get("prepared", 0)
         == r["journal"].get("committed", 0) + r["journal"].get("aborted", 0)
         and r["in_flight"] == 0, (r["journal"], r["in_flight"])),
        ("nothing_pending_or_parked", (r["pending"], r["parked"]) == (0, 0),
         (r["pending"], r["parked"])),
        ("every_tick_served", all(o["served"] for o in obs),
         [t for t, o in enumerate(obs) if not o["served"]][:10])]


def phase_fleet_lockstep(K, dev, size: dict) -> tuple:
    """15a: ``FleetWorld`` on the card against a lockstep CPU leg, tick for
    tick, both held to the fleet's books. Returns (K1/K2 launches, the
    kernels' entries after the inbound herd and after the adoption)."""
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="fleet-lockstep-")
    t_phase = time.perf_counter()
    try:
        card, rc = run_fleet_leg(P, dev, size, scratch, K)
        cpu, rp = run_fleet_leg(P, torch.device("cpu"), size, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    check(len(card) == len(cpu), f"15a: {len(card)} card and {len(cpu)} cpu ticks")
    for t in range(len(card)):
        where = first_gateway_diff(card[t], cpu[t])
        check(where is None, f"15a tick {t}: cuda and cpu differ: {where}")
    for leg, obs, r in (("cuda", card, rc), ("cpu", cpu, rp)):
        for name, ok, detail in fleet_checks(obs, r):
            check(ok, f"15a {leg}: {name}: {str(detail)[:300]}")
    for t, o in enumerate(card):
        want = {name: o["ran"] for name in o["launches"]}
        check(o["launches"] == want, f"15a tick {t}: launches {o['launches']} in {o['ran']} "
                                     f"engine ticks (one of each per engine tick)")
        if o["served"] and not o["census"]:
            check(o["reads"] == 2, f"15a tick {t}: {o['reads']} device reads, not 2 (the "
                                   f"consume blob and the query plane's changed rows)")
    check(set(rc["kernels"]) == {"herd", "adoption"},
          f"15a: K1/K2 held on the live tensors of {sorted(rc['kernels'])} only")
    ledger, control = rc["ledger"], rc["control"]
    trunk_out = sum(len(o["trunk"][gw]) for o in card for gw in o["trunk"])
    print(f"15a fleet lockstep: gateway a of scripts/global_soak.py's WORLD_3 (6x4 cells of 50 m, "
          f"three 2x4 blocks; a hosts {rc['local_cells']} cells) on the device controller at "
          f"{size['entity_capacity']} slots / {size['query_capacity']} query rows, "
          f"{len(card)} GLOBAL ticks of a fixed {FLEET_TICK_S * 1e3:g} ms clock (epoch "
          f"{FLEET_EPOCH_TICKS} ticks), {size['entities']} entities, {size['agents']} sim "
          f"agents, {size['sensors']} sensors, {size['followers']} followers; stub peers b and c "
          f"behind tapped trunks: outbound {size['burst']} ({size['burst_agents']} agents), "
          f"refused {size['refusal']}, inbound {size['herd']} ({size['herd_agents']} agents), "
          f"severed {size['sever']}, c's adoption of {size['adopt']} + 2 in-flight entities and "
          f"{size['adopt_sensors']} sensor rows (b claimed {size['claimed']}) on tick "
          f"{rc['adopted_at']}; every check held on both legs: "
          + ", ".join(name for name, _, _ in fleet_checks(card, rc))
          + f"; federation ledger {ledger}, control counters {control}, sim {rc['sim']}; "
          f"{trunk_out} trunk messages from a; cuda equals the CPU leg on every tick (handovers, "
          f"trunk messages as bytes in order, tables, placement ledger, engine slots, cells and "
          f"counts, agents and sim columns, changed query rows, every ledger, the peers' "
          f"holdings, every outbound stream); 2 device reads a steady tick; launches "
          f"{rc['launches']} in {rc['engine_ticks']} engine ticks; phase "
          f"{time.perf_counter() - t_phase:.1f} s (card leg {rc['secs']:.1f} s, cpu leg "
          f"{rp['secs']:.1f} s)")
    for leg, obs in (("cuda", card), ("cpu", cpu)):
        steps = [o["step_ms"] for o in obs[1:] if o["step_ms"] is not None]
        print(f"15a on {leg}: tick (host clock) {tick_stats([o['tick_ms'] for o in obs[1:]])}; "
              f"guarded step {tick_stats(steps)}")
    entries: dict = {}
    for case, ks in sorted(rc["kernels"].items()):
        for name, k in ks.items():
            entries.setdefault(name, {})[f"15a_{case}"] = k
            print(f"15a {name} on the live tensors after the {case} ({k['shape']}): exact; "
                  f"alone {k['ms']:.4f} ms (events, bare launches), plain {k['plain_ms']:.4f} "
                  f"ms, bound {k['bound_ms']:.6f} ms ({k['bound_by']})")
    return rc["launches"], entries



# ---- 15b: scripts/federation_soak.py's live fleet through the port ----------


def fed_auth_frame(P, pit: str) -> bytes:
    return soak_frame(P, P.types.MessageType.AUTH, P.control_pb2.AuthMessage(
        playerIdentifierToken=pit, loginToken="fed-soak").SerializeToString())




async def wait_redirect(P, host: str, port: int, pit: str, result: dict, stop) -> None:
    """scripts/global_soak.py's ``wait_redirect``: connect to gateway a,
    record the ClientRedirectMessage under ``redirect`` and stop there."""
    import asyncio

    MT = P.types.MessageType
    reader, writer = await asyncio.open_connection(host, port)
    await soak_auth(P, reader, writer, pit, timeout=8.0)
    result["authed_a"] = True
    dec = P.protocol.FrameDecoder()
    while "redirect" not in result and not stop.is_set():
        try:
            data = await asyncio.wait_for(reader.read(65536), timeout=0.5)
        except asyncio.TimeoutError:
            continue
        except (ConnectionError, OSError):
            break
        if not data:
            break
        for packet in dec.decode_packets(data):
            for mp in packet.messages:
                if mp.msgType == MT.CLIENT_REDIRECT:
                    rd = P.control_pb2.ClientRedirectMessage()
                    rd.ParseFromString(mp.msgBody)
                    result["redirect"] = dict(gateway=rd.gatewayId, addr=rd.addr,
                                              entity=rd.entityId, channel=rd.channelId)
    writer.close()


async def resume_on(P, host: str, port: int, pit: str, result: dict, suffix: str = "") -> None:
    """scripts/global_soak.py's ``resume_on``: dial a gateway with the same
    PIT and record whether the session resumed through recovery
    (``auth_result{suffix}``, ``should_recover``, ``recovery_end``, the
    recovered channels)."""
    import asyncio

    MT = P.types.MessageType
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(fed_auth_frame(P, pit))
    await writer.drain()
    dec = P.protocol.FrameDecoder()
    deadline = time.monotonic() + 10.0
    recovery_channels = []
    while time.monotonic() < deadline:
        try:
            data = await asyncio.wait_for(reader.read(65536), timeout=1.0)
        except asyncio.TimeoutError:
            continue
        except (ConnectionError, OSError):
            break
        if not data:
            break
        done = False
        for packet in dec.decode_packets(data):
            for mp in packet.messages:
                if mp.msgType == MT.AUTH:
                    ar = P.control_pb2.AuthResultMessage()
                    ar.ParseFromString(mp.msgBody)
                    result[f"auth_result{suffix}"] = int(ar.result)
                    result["should_recover"] = bool(ar.shouldRecover)
                    result[f"conn_id{suffix}"] = ar.connId
                elif mp.msgType == MT.RECOVERY_CHANNEL_DATA:
                    rm = P.control_pb2.ChannelDataRecoveryMessage()
                    rm.ParseFromString(mp.msgBody)
                    recovery_channels.append(rm.channelId)
                elif mp.msgType == MT.RECOVERY_END:
                    result["recovery_end"] = True
                    done = True
        if done:
            break
    result["recovery_channels"] = recovery_channels
    writer.close()


async def fed_redirect_client(P, host: str, port: int, pit: str, result: dict, stop) -> None:
    """scripts/federation_soak.py's ``redirect_client``: connect to gateway
    a, wait for a ClientRedirectMessage, follow it to gateway b and record
    whether the resume was seamless."""
    await wait_redirect(P, host, port, pit, result, stop)
    result["redirected"] = "redirect" in result
    if result["redirected"]:
        r_host, _, r_port = result["redirect"]["addr"].rpartition(":")
        await resume_on(P, r_host or host, int(r_port), pit, result, suffix="_b")


class FedChild:
    """scripts/federation_soak.py's Child: the stdin/stdout handle of a
    child gateway process (with the time just before its start and its
    log, where the caller keeps them)."""

    def __init__(self, proc, t0: Optional[float] = None, log: Optional[str] = None):
        self.proc, self.t0, self.log = proc, t0, log

    async def _readline(self, timeout: float) -> str:
        import asyncio

        loop = asyncio.get_running_loop()
        return await asyncio.wait_for(loop.run_in_executor(None, self.proc.stdout.readline),
                                      timeout)

    async def wait_for(self, prefix: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = await self._readline(deadline - time.monotonic())
            if not line:
                raise RuntimeError("federation child died")
            line = line.strip()
            if line.startswith(prefix):
                return line
        raise TimeoutError(f"child never answered {prefix!r}")

    async def cmd(self, name: str, timeout: float = 15.0, **kw) -> str:
        self.proc.stdin.write(json.dumps({"cmd": name, **kw}) + "\n")
        self.proc.stdin.flush()
        return await self.wait_for(f"OK {name}", timeout)


def child_boot(child: FedChild, line: str) -> dict:
    """A host-grid child's boot from its READY line: the JSON's parts (and
    its foreign modules) with ``boot_s``, Popen to READY."""
    info = json.loads(line[len("READY"):].strip() or "{}")
    return dict(info, boot_s=round(time.perf_counter() - child.t0, 3))


async def run_fed_soak(P, p: FedSoakParams, scratch: str) -> dict:
    """scripts/federation_soak.py's ``run_fed_soak`` through the port: gateway
    "a" in-process on this asyncio loop, gateway "b" a ``--fed-child`` process
    of this script; both on the script's WORLD_SPATIAL, whose
    Static2DSpatialController touches no device. The boot, the five phases,
    the invariants and the stats under the script's names; the report also
    carries the child's foreign modules and its controller."""
    import asyncio
    import os

    from random import Random

    journal = P.failover.journal
    t_start = time.monotonic()
    ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client"), fed_free_ports(4)))
    fed_cfg = fed_config(ports)
    cfg_path = os.path.join(scratch, f"fed_soak_cfg_{os.getpid()}.json")
    report_path = os.path.join(scratch, f"fed_soak_report_{os.getpid()}.json")
    log_path = os.path.join(scratch, "fed_child.log")
    with open(cfg_path, "w") as f:
        json.dump(fed_cfg, f)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        child_proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fed-child", cfg_path, report_path],
            cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log, text=True)
    child = FedChild(child_proc, t0)
    stop = asyncio.Event()
    gw = None
    timeline: list = []
    notes: list = []

    def mark(phase: str, **kw) -> None:
        timeline.append({"t": round(time.monotonic() - t_start, 2), "phase": phase, **kw})

    try:
        try:
            boot = child_boot(child, await child.wait_for("READY", p.child_boot_timeout_s))
        except (RuntimeError, TimeoutError) as e:
            with open(log_path) as f:
                tail = f.read()[-600:]
            raise PhaseFailed(f"15b: the --fed-child gateway did not boot ({e}): {tail}")
        gw = await fed_boot_gateway(P, "a", fed_cfg, p, stop, scratch)
        plane, ctl = gw["plane"], gw["ctl"]
        baseline = P.invariants.scrape()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and plane.link_to("b") is None:
            await asyncio.sleep(0.05)
        if plane.link_to("b") is None:
            raise PhaseFailed("15b: trunk to b never came up")
        mark("trunk_up")
        sim = FedSim(P, ctl, Random(p.seed ^ 0xA))
        sim.create_entities(p.entities, -98.0, -2.0, -98.0, 98.0)
        await asyncio.sleep(0.5)
        redirect_result: dict = {}
        anchor_eid = sim.entity_ids[0]
        client_task = asyncio.ensure_future(fed_redirect_client(
            P, "127.0.0.1", gw["client_port"], "fed-client-0", redirect_result, stop))
        cdeadline = time.monotonic() + 10.0
        anchor_conn = None
        while time.monotonic() < cdeadline and anchor_conn is None:
            for conn in P.connection.all_connections().values():
                if getattr(conn, "pit", "") == "fed-client-0" and not conn.is_closing():
                    anchor_conn = conn
                    break
            await asyncio.sleep(0.05)
        if anchor_conn is None:
            raise PhaseFailed("15b: anchored client never authed")
        plane.set_client_anchor(anchor_conn, anchor_eid)

        async def wait_ledger(key: str, at_least: int, timeout: float) -> bool:
            end = time.monotonic() + timeout
            while time.monotonic() < end:
                if plane.ledger.get(key, 0) >= at_least:
                    return True
                await asyncio.sleep(0.05)
            return False

        # ---- phase 1: commit burst (includes the anchor entity) ----
        sim.herd(sim.entity_ids[: p.burst], 2.0, 98.0, -98.0, 98.0)
        if not await wait_ledger("committed", p.burst, p.phase_timeout_s):
            notes.append(f"commit burst incomplete: {plane.ledger.get('committed', 0)}/{p.burst}")
        committed_burst = plane.ledger.get("committed", 0)
        mark("commit_burst", committed=committed_burst)
        rdeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < rdeadline and not redirect_result.get("recovery_end"):
            await asyncio.sleep(0.1)
        mark("redirect", **{k: v for k, v in redirect_result.items()
                            if k != "recovery_channels"})

        # ---- phase 2: refusal under destination L3 ----
        await child.cmd("force_l3")
        refusal_ids = sim.local_ids()[: p.refusal_burst]
        sim.herd(refusal_ids, 2.0, 98.0, -98.0, 98.0)
        if not await wait_ledger("refused", 1, p.phase_timeout_s):
            notes.append("no refusal observed under destination L3")
        refused_batches = plane.ledger.get("refused", 0)
        await child.cmd("clear_l3")
        if not await wait_ledger("committed", committed_burst + len(refusal_ids),
                                 p.phase_timeout_s):
            notes.append("refused entities never re-committed after L3 clear")
        mark("refusal", refused=refused_batches, busy_frames=plane.busy_frames)

        # ---- phase 3: sever mid-burst ----
        sever_ids = sim.local_ids()[: p.sever_burst]
        committed_before_sever = plane.ledger.get("committed", 0)
        aborted_before_sever = plane.ledger.get("aborted", 0)
        sim.herd(sever_ids, 2.0, 98.0, -98.0, 98.0)
        sdeadline = time.monotonic() + 5.0
        severed = False
        while time.monotonic() < sdeadline:
            link = plane.link_to("b")
            if plane._pending and link is not None:
                link.sever_for_test()
                severed = True
                break
            if not plane._pending and plane.ledger.get(
                    "committed", 0) >= committed_before_sever + len(sever_ids):
                break  # all acks won the race
            await asyncio.sleep(0)
        if not severed:
            notes.append("sever raced: no batch in flight at cut time")
        ddeadline = time.monotonic() + p.phase_timeout_s * 2
        while time.monotonic() < ddeadline and (plane._pending or plane._parked):
            await asyncio.sleep(0.1)
        mark("sever", severed=severed,
             aborted=plane.ledger.get("aborted", 0) - aborted_before_sever,
             pending_after=len(plane._pending), parked_after=len(plane._parked))

        # ---- phase 4: herd back (b initiates, a receives) ----
        await child.cmd("herd_back", n=p.herd_back)
        if not await wait_ledger("applied", 1, p.phase_timeout_s):
            notes.append("no b->a handover applied")
        mark("herd_back", applied=plane.ledger.get("applied", 0))

        # ---- quiesce + census ----
        await child.cmd("quiesce", timeout=p.phase_timeout_s + 5.0, drain_s=p.phase_timeout_s)
        qdeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < qdeadline and (
                plane._pending or plane._parked or journal.in_flight_count()):
            await asyncio.sleep(0.1)
        await asyncio.sleep(p.quiesce_s)
        await child.cmd("report", timeout=15.0)
        with open(report_path) as f:
            b_report = json.load(f)
        a_placement = fed_local_placement(P)
        b_placement = dict(b_report["placement"])
        local_dups_a = a_placement.pop("__local_dups__", [])
        local_dups_b = b_placement.pop("__local_dups__", [])
        inv = P.invariants.InvariantChecker()
        inv.expect_gt("cross_gateway_handovers_committed", plane.ledger.get("committed", 0), 0)
        inv.expect_le("commit_burst_reached_target", p.burst, committed_burst,
                      f"burst committed {committed_burst}/{p.burst}")
        inv.check("trunk_severed_mid_burst", severed, str(notes))
        inv.expect_gt("sever_aborted_back_to_source", plane.ledger.get("aborted", 0), 0)
        inv.expect_equal("nothing_left_in_flight",
                         (len(plane._pending), len(plane._parked), b_report["pending"],
                          b_report["parked"]), (0, 0, 0, 0))
        counts: dict = {}
        for eid, cell in a_placement.items():
            counts.setdefault(eid, []).append(("a", cell))
        for eid, cell in b_placement.items():
            counts.setdefault(eid, []).append(("b", cell))
        expected = {str(e) for e in sim.entity_ids}
        missing = sorted(e for e in expected if e not in counts)
        duplicated = {e: where for e, where in counts.items() if len(where) > 1}
        unexpected = sorted(e for e in counts if e not in expected)
        inv.expect_equal("every_entity_on_exactly_one_gateway",
                         (missing, duplicated, unexpected, local_dups_a, local_dups_b),
                         ([], {}, [], [], []))
        inv.expect_gt("l3_refusal_fired", refused_batches, 0)
        inv.expect_equal("refusals_equal_busy_frames", plane.ledger.get("refused", 0),
                         plane.busy_frames)
        inv.expect_equal("remote_refusals_match", b_report["ledger"].get("refused_remote", 0),
                         plane.ledger.get("refused", 0))
        inv.check("client_redirected", redirect_result.get("redirected", False),
                  str(redirect_result))
        inv.check("redirect_resumed_without_reauth",
                  redirect_result.get("should_recover", False)
                  and redirect_result.get("auth_result_b", -1) == 0
                  and redirect_result.get("recovery_end", False), str(redirect_result))
        a_metric = fed_metric_delta(P, baseline)
        a_ledger_counters = {k: v for k, v in plane.ledger.items()
                             if k not in ("redirects", "staged")}
        inv.expect_equal("a_ledger_matches_metric", a_metric, a_ledger_counters)
        b_ledger_counters = {k: v for k, v in b_report["ledger"].items()
                             if k not in ("redirects", "staged")}
        inv.expect_equal("b_ledger_matches_metric", b_report["metric_delta"], b_ledger_counters)
        inv.expect_equal("a_commits_equal_b_applies_minus_reconciled",
                         plane.ledger.get("committed", 0),
                         b_report["ledger"].get("applied", 0)
                         - b_report["ledger"].get("reconciled", 0))
        inv.expect_equal("b_commits_equal_a_applies_minus_reconciled",
                         b_report["ledger"].get("committed", 0),
                         plane.ledger.get("applied", 0) - plane.ledger.get("reconciled", 0))
        jc = dict(journal.counts)
        inv.expect_equal("journal_prepared_equals_committed_plus_aborted", jc.get("prepared", 0),
                         jc.get("committed", 0) + jc.get("aborted", 0), f"counts={jc}")
        inv.expect_equal("journal_nothing_in_flight", journal.in_flight_count(), 0)
        report = {
            "kind": "federation_soak", "duration_s": round(time.monotonic() - t_start, 2),
            "entities": p.entities,
            "phases": {"burst": p.burst, "refusal_burst": p.refusal_burst,
                       "sever_burst": p.sever_burst, "herd_back": p.herd_back},
            "timeline": timeline, "redirect": redirect_result,
            "gateway_a": {"ledger": dict(plane.ledger), "busy_frames": plane.busy_frames,
                          "metric_delta": a_metric, "trunk": fed_trunk_metrics(P, baseline),
                          "spatial": type(ctl).__name__},
            "gateway_b": b_report,
            "boot": {"b": boot},
            "census": {"expected": len(expected), "on_a": len(a_placement),
                       "on_b": len(b_placement), "missing": missing,
                       "duplicated": {str(k): v for k, v in duplicated.items()}},
            "invariants": inv.summary(),
            "stats": {"committed": plane.ledger.get("committed", 0),
                      "aborted": plane.ledger.get("aborted", 0),
                      "refused": plane.ledger.get("refused", 0),
                      "applied_from_b": plane.ledger.get("applied", 0),
                      "b_applied": b_report["ledger"].get("applied", 0),
                      "b_reconciled": b_report["ledger"].get("reconciled", 0),
                      "redirects": plane.ledger.get("redirects", 0)},
        }
        if notes:
            report["notes"] = notes
        stop.set()
        client_task.cancel()
        return report
    finally:
        stop.set()
        stop_processes([child_proc])
        if gw is not None:
            fed_teardown_gateway(P, gw)


def fed_soak_checks(r: dict) -> list:
    """15b's checks of one report, as (name, held, detail): every invariant
    of scripts/federation_soak.py under its own name, then
    tests/test_federation.py::test_federation_smoke_soak's bars, the child
    a gateway of the port with no module of torch, of JAX or of the JAX package."""
    out = [(c["name"], c["ok"], c.get("detail", "")) for c in r["invariants"]["checks"]]
    st, census, b = r["stats"], r["census"], r["gateway_b"]
    return out + [
        ("at_least_8_committed", st["committed"] >= 8, st["committed"]),
        ("at_least_1_refused", st["refused"] >= 1, st["refused"]),
        ("exactly_1_redirect", st["redirects"] == 1, st["redirects"]),
        ("census_nothing_missing", census["missing"] == [], census["missing"]),
        ("census_nothing_duplicated", census["duplicated"] == {}, census["duplicated"]),
        ("child_imports_no_jax", b.get("modules") == [], b.get("modules")),
        ("both_gateways_on_the_host_grid",
         (r["gateway_a"]["spatial"], b.get("spatial")) == ("StaticGrid2DSpatialController",) * 2,
         (r["gateway_a"]["spatial"], b.get("spatial")))]


def fed_smoke_params(**kw) -> FedSoakParams:
    """tests/test_federation.py::test_federation_smoke_soak's parameters."""
    return FedSoakParams(**dict(dict(entities=32, burst=8, refusal_burst=4, sever_burst=8,
                                     herd_back=6, phase_timeout_s=15.0, quiesce_s=1.5), **kw))


def phase_fed_live(p: FedSoakParams) -> dict:
    """15b: ``run_fed_soak`` through the port with a ``--fed-child`` gateway,
    held to every invariant of the script and to the smoke test's bars."""
    import asyncio
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="fed-live-")
    t_phase = time.perf_counter()
    try:
        r = asyncio.run(run_fed_soak(P, p, scratch))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name, ok, detail in fed_soak_checks(r):
        check(ok, f"15b: {name}: {str(detail)[:300]}")
    st, a, b = r["stats"], r["gateway_a"], r["gateway_b"]
    print(f"15b federation live: scripts/federation_soak.py's run_fed_soak through the port, "
          f"gateway a in-process and gateway b a `chip_smoke.py --fed-child` process (no module "
          f"of torch, of JAX or of the JAX package loaded), both on WORLD_SPATIAL's "
          f"Static2DSpatialController: this fleet touches no device, by the script's own "
          f"design; {p.entities} entities, bursts {p.burst} / {p.refusal_burst} / "
          f"{p.sever_burst} / {p.herd_back}; every invariant of the script held "
          f"({len(r['invariants']['checks'])}); stats {st}; trunk a {a['trunk']}; census "
          f"{r['census']['on_a']} on a + {r['census']['on_b']} on b of "
          f"{r['census']['expected']}, none missing or duplicated; timeline "
          f"{[(m['phase'], m['t']) for m in r['timeline']]}; child boot "
          f"{boot_line(r['boot'])}; soak {r['duration_s']} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return r


def phase_fleet(K, dev) -> tuple:
    """15a and 15b. Returns ({path: launches}, {kernel: {case: entry}})."""
    t_phase = time.perf_counter()
    launches, entries = phase_fleet_lockstep(K, dev, fleet_size())
    phase_fed_live(fed_smoke_params())
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return {"fleet_lockstep": launches}, entries


# ---- phase 16: the crash soak: a GPU-controlled gateway SIGKILLed and restarted ----



# 16a's ticks of a fixed 50 ms clock: stub a's control epoch (250 ms) is 5
# ticks, b's plane timeout sweep (100 ms) 2, b's snapshot loop (2.0 s) 40
# ticks from each boot. b's own control epoch (10 s) never comes round in
# an incarnation of the run (the longest is 2.35 s), as in the soak's.
CRASH_TICK_S = 0.05
CRASH_EPOCH_TICKS = 5
CRASH_SWEEP_TICKS = 2
CRASH_SNAPSHOT_TICKS = 40
# The stub trunk's directory ports: written into the shard directory, never opened.
CRASH_PORTS = dict(a_trunk=17011, a_client=17012, b_trunk=17013, b_client=17014)
CRASH_CELLS = {"a": (0, 1, 4, 5, 8, 9, 12, 13), "b": (2, 3, 6, 7, 10, 11, 14, 15)}
# The ticks each event of 16a's script happens on. b is down from the end of
# each kill tick until its restart tick; the first kill falls after b's first
# snapshot (tick 40), the second after the first incarnation's (tick 90).
CRASH_AT = dict(commit_in=5, commit_out=10, burst1=44, kill1=46, restart1=50, trunk1=53,
                reoffer=56, torn=94, burst2=96, kill2=97, restart2=122, trunk2=125)
# Sim passes between journaled censuses (the gateway's default is 50;
# scripts/sim_soak.py's kill leg journals every 4): the snapshot does not
# carry the census, so a restart restores the last one journaled after it.
CRASH_CENSUS_EVERY = 4


def crash_size(**kw) -> dict:
    """16a's sizes: the gateway's tables (1<<17 entity slots, 4,096 query
    rows), scripts/crash_soak.py's acceptance run (CrashSoakParams: 12 base
    entities a side, 4 commits each way, a kill burst of 8), 64 sim agents,
    4 sensor rows, 2 crossings parked across the first restart."""
    p = CrashSoakParams()
    size = dict(entity_capacity=1 << 17, query_capacity=4096, entities=p.base_entities,
                commits=p.committed_each_way, burst=p.kill_burst, agents=64, sensors=4,
                parked=2, ticks=150, deadline_s=GATEWAY_DEADLINE_S)
    size.update(kw)
    return size


def wal_barrier(wal, since: int, timeout_s: float = 30.0) -> None:
    """``wal.flush()`` on the host's clock (the run's monotonic clock is
    fixed): every record appended so far fsync'd, or the writer no longer
    alive (wedged by a tear). ``since`` is the sequence the writer started
    from: a new process's writer counts its flushes from 0, so with
    nothing appended since there is nothing to wait for."""
    target = wal.current_seq()
    deadline = time.perf_counter() + timeout_s
    while target > since and wal.report()["flushed_seq"] < target and wal.writer_alive():
        check(time.perf_counter() < deadline, f"the WAL writer did not flush seq {target} "
                                              f"({wal.report()})")
        time.sleep(0.001)


def wal_wait(what: str, done, timeout_s: float = 30.0) -> None:
    """Wait on the host's clock until ``done()`` (the writer thread's work
    seen on disk)."""
    deadline = time.perf_counter() + timeout_s
    while not done():
        check(time.perf_counter() < deadline, f"the WAL writer did not {what}")
        time.sleep(0.001)


class CrashStub:
    """16a's gateway "a", the leader, scripted behind a ``TrunkTap``: its own
    entities (scripts/crash_soak.py's base population on a's side), the
    batches it prepares into b, the acks, abort notices, load reports, the
    death declaration after the miss window, the adoption (its copies of
    what it committed into b), the directory sync on b's return, and the
    resurrection acks (``shardAdopted``, ``isAdopter``,
    ``missingEntityIds``). It answers through b's own trunk dispatch
    (``plane._on_trunk_message``). ``hold`` leaves b's messages unread on the
    link: at a kill they are lost in flight."""

    def __init__(self, world, rng):
        self.w, self.P, self.rng = world, world.P, rng
        self.link = None
        self.read = 0
        self.census: set = set()
        self.own: list = []         # its own entities, in creation order
        self.pos: dict = {}         # entity id -> (x, z) while held here
        self.pending: dict = {}     # our prepares' batch id -> rows
        self.retained: dict = {}    # committed into b: batch id -> ids
        self.aborted: list = []     # rows of batches aborted by b's death, re-offered later
        self.notices: set = set()   # aborted batch ids, flushed on trunk up
        self.applied: dict = {}     # b's batches applied here: batch id -> ids
        self.hold = False
        self.up = False
        self.down_since = None
        self.death_ticks = None     # the miss window in ticks (None: pinned open)
        self.dead = False
        self.directory_version = 0
        self.resurrections: dict = {}
        self.batch = 0
        self.epoch = 0
        self.log: list = []         # what the stub did, in order

    def deliver(self, msg_type, msg) -> None:
        self.w.plane._on_trunk_message("a", int(msg_type), msg)

    def connect(self, link) -> None:
        """b's trunk came up (a new link each incarnation): flush the abort
        notices, then, after a death, the full directory sync (real a's
        ``_on_trunk_up`` order)."""
        P = self.P
        MT, pb = P.types.MessageType, P.control_pb2
        self.link, self.read, self.up, self.down_since = link, 0, True, None
        if self.notices:
            self.deliver(MT.TRUNK_ABORT_NOTICE,
                         pb.TrunkAbortNoticeMessage(batchIds=sorted(self.notices)))
            self.log.append(("notices", sorted(self.notices)))
            self.notices.clear()
        if self.dead:
            msg = pb.TrunkDirectoryUpdateMessage(version=self.directory_version,
                                                 replaceOverrides=True)
            for cid in self.w.b_cells:
                msg.overrides.add(channelId=cid, gatewayId="a")
            self.deliver(MT.TRUNK_DIRECTORY_UPDATE, msg)
            self.log.append(("directory_sync", self.directory_version))
            self.dead = False  # the returnee is live again (real a's dead.discard)

    def disconnect(self, t: int) -> None:
        """b died: what it sent since the last read is lost in flight, and
        every batch pending at b aborts here (restored, notice queued)."""
        self.up, self.down_since = False, t
        self.read = len(self.link.sent)
        for bid, rows in sorted(self.pending.items()):
            self.census.update(e for e, _, _ in rows)
            self.aborted.extend(rows)
            self.notices.add(bid)
            self.log.append(("aborted", bid, [e for e, _, _ in rows]))
        self.pending.clear()

    def answer(self) -> None:
        if not self.up or self.hold:
            return
        P = self.P
        MT, pb = P.types.MessageType, P.control_pb2
        new = self.link.sent[self.read:]
        self.read = len(self.link.sent)
        for t, body, cls in new:
            msg = cls.FromString(body)
            if t == MT.TRUNK_HANDOVER_PREPARE:
                ids = [e.entityId for e in msg.entities]
                self.census.update(ids)
                for e in msg.entities:
                    pos = P.anyutil.unpack_any(e.data).state.transform.position
                    self.pos[e.entityId] = (pos.x, pos.z)
                self.applied[msg.batchId] = ids
                self.log.append(("applied", msg.batchId, ids))
                self.deliver(MT.TRUNK_HANDOVER_ACK, pb.TrunkHandoverAckMessage(
                    batchId=msg.batchId, committed=True, traceId=msg.traceId))
            elif t == MT.TRUNK_HANDOVER_ACK:
                rows = self.pending.pop(msg.batchId, [])
                ids = [e for e, _, _ in rows]
                if msg.committed:
                    self.retained[msg.batchId] = ids
                    for e in ids:
                        self.pos.pop(e, None)
                else:
                    self.census.update(ids)
                self.log.append(("ack", msg.batchId, bool(msg.committed)))
            elif t == MT.TRUNK_ABORT_NOTICE:
                for bid in msg.batchIds:
                    self.census.difference_update(self.applied.pop(bid, []))
                self.log.append(("purged", sorted(msg.batchIds)))
            elif t == MT.TRUNK_RESURRECT_HELLO and not msg.ack:
                adopted = bool(self.directory_version)
                reply = pb.TrunkResurrectHelloMessage(
                    gatewayId="a", ack=True, shardAdopted=adopted,
                    directoryVersion=self.directory_version)
                if adopted:
                    reply.isAdopter = True
                    reply.missingEntityIds.extend(e for e in msg.entityIds
                                                  if e not in self.census)
                outcome = "peer_yielded" if adopted else "peer_reclaimed"
                self.resurrections[outcome] = self.resurrections.get(outcome, 0) + 1
                self.log.append(("hello", sorted(msg.cellIds), sorted(msg.entityIds),
                                 sorted(reply.missingEntityIds)))
                self.deliver(MT.TRUNK_RESURRECT_HELLO, reply)

    def epoch_tick(self, t: int) -> None:
        """Stub a's control epoch: its load report to b, and the leader's
        death check (b silent for the whole miss window: declared dead,
        its shard adopted here)."""
        P = self.P
        self.epoch += 1
        if self.up:
            self.deliver(P.types.MessageType.TRUNK_LOAD_REPORT, P.control_pb2.TrunkLoadReportMessage(
                gatewayId="a", epoch=self.epoch, entities=len(self.census), cells=8,
                trunkRttMs=1.0, directoryVersion=self.directory_version))
        elif (self.death_ticks is not None and not self.dead
              and t - self.down_since >= self.death_ticks):
            self.dead = True
            self.directory_version += 1
            for ids in self.retained.values():  # resurrection candidates restored here
                self.census.update(ids)
            self.log.append(("declared_dead", t, self.directory_version))

    def herd(self, n: int, t: int) -> list:
        """Up to ``n`` of the entities held here into b's half, as batches
        per (source, destination) cell pair; returns the ids sent."""
        w = self.w
        ids = [e for e in self.own + sorted(self.census - set(self.own))
               if e in self.census and e in self.pos][:n]
        groups: dict = {}
        for eid in ids:
            x, z = self.rng.uniform(*CRASH_XR["b"]), self.rng.uniform(*CRASH_ZR)
            src = w.cell_of(*self.pos[eid])
            groups.setdefault((src, w.cell_of(x, z)), []).append((eid, x, z))
        for (src, dst), rows in sorted(groups.items()):
            self.prepare(src, dst, rows)
        return ids

    def prepare(self, src: int, dst: int, rows: list) -> None:
        P = self.P
        self.batch += 1
        bid = 9000 + self.batch
        msg = P.control_pb2.TrunkHandoverPrepareMessage(
            batchId=bid, srcChannelId=src, dstChannelId=dst, traceId=f"a-herd-{self.batch}")
        for i, (eid, x, z) in enumerate(rows):
            e = msg.entities.add(entityId=eid, txnId=bid + i)
            e.data.CopyFrom(P.anyutil.pack_any(sim_entity_data(P, eid, x, z)))
        self.pending[bid] = rows
        self.census.difference_update(e for e, _, _ in rows)  # in flight: on neither side's books
        self.log.append(("prepare", bid, src, dst, [e for e, _, _ in rows]))
        self.deliver(P.types.MessageType.TRUNK_HANDOVER_PREPARE, msg)

    def reoffer(self) -> list:
        """Re-offer the batches b's death aborted (real a's parked crossings)."""
        w, rows, self.aborted = self.w, self.aborted, []
        groups: dict = {}
        for eid, x, z in rows:
            groups.setdefault((w.cell_of(*self.pos[eid]), w.cell_of(x, z)), []).append((eid, x, z))
        for (src, dst), batch in sorted(groups.items()):
            self.prepare(src, dst, batch)
        return [e for e, _, _ in rows]


class CrashWorld:
    """16a: gateway "b" of scripts/crash_soak.py's world, the crash victim, on
    the device controller, through one package's modules ``P``: WORLD_SPATIAL
    (4x4 cells of 50 m at -100, two server blocks, b owns x > 0) as a
    ``TPUSpatialController`` (the port's alias of ``GPUSpatialController``)
    with the sim plane, the query plane and the device guard on, the crash
    soak's directory, boot pins and ``wal_settings_hook("b")``: the WAL and
    the snapshot armed in ``state_dir``. Gateway "a", the leader, is a
    ``CrashStub``. A fixed 50 ms clock runs b's plane timeout sweep, b's
    control epoch and snapshot loop, and the stub's epoch.

    The WAL's writer thread flushes at the end of every tick b serves (the
    soak's durability barrier), so each kill loses exactly the fsync window
    of the tick it falls in: the file is cut back to its last flushed
    length. A kill stops the writer without a flush and drops every
    process-wide registry, the engine's tensors, the trace-id counter and
    K1's counts buffers; a restart boots as scripts/crash_soak.py's child
    does (controller, the local shard claimed, ``boot_replay`` of the
    snapshot and the WAL, the writer started above the replayed sequence,
    the plane up, the trunk up three ticks later).

    The script (``CRASH_AT``): commits both ways; a kill mid-burst (the
    stub's batches in flight, one applied and durable, one applied in the
    lost window); restart 1, b's own crossings parked before its trunk is
    up, the hello and the reclaim, the stub's abort notices purging the
    applied copy, both sides' parked crossings re-offered and committed;
    ``wal.torn_write`` armed and a second kill mid-burst; the stub's death
    declaration and adoption; restart 2 over the torn tail; the yield.
    Records per tick the handovers, the trunk messages b sent, the tables,
    the placement ledger, the engine's slots, cells and counts, the agents
    and sim columns, the changed query rows, the ledgers, the WAL's bytes,
    the snapshot and the stub's holdings."""

    def __init__(self, P, dev: torch.device, clock, size: dict, state_dir: str, config: str,
                 K=None):
        from random import Random

        self.P, self.dev, self.clock, self.size, self.K = P, dev, clock, size, K
        self.state_dir, self.config = state_dir, config
        self.p = CrashSoakParams()
        self.snap_path, self.wal_path = persistence_paths(state_dir, "b")
        self.rng = Random(self.p.seed ^ 0xB)
        self.conns: list = []
        self.handovers, self.step_ms, self.rebuild_ms = [], [], []
        self.engine_ticks = 0
        self.events: list = []
        self.kernels: dict = {}
        self.replays: list = []      # each restart's boot_replay report
        self.restarts: list = []     # each restart's host seconds (kill to booted)
        self.kills: list = []        # each kill's books
        self.durable: list = []      # each kill's WAL and snapshot files, as bytes
        self.booted: list = []       # each restart's booted_state()
        self.memory: list = []       # (moment, bytes allocated on the card)
        self.columns: list = []
        self.down = False
        self.flushed = 0             # the WAL file's length at the last flush
        self.placed_ever: set = set()
        self.torn = False            # the torn prefix is on disk
        self.durable_census = None   # (agents, sim tick, ids) of the last census fsync'd
        self.stub = CrashStub(self, Random(self.p.seed ^ 0xA))
        self.traced = [sys.modules[type(o).__module__]
                       for o in (P.federation.plane, P.federation.control)]
        self.trace_ids = [m.new_trace_id for m in self.traced]
        self.note_memory("before boot")
        self.boot(0)
        self.entity_ids = self._entities()
        self.sensor_keys = self._sensors()
        self.trunk_up()

    _wrap = SoakWorld._wrap

    def conn(self, conn_id: int, kind: str):
        c = GatewayWorld.conn(self, conn_id, kind)
        if self.size.get("columns"):
            c.frames = []
        return c

    # ---- one process image -------------------------------------------------

    def boot(self, t: int) -> None:
        """A fresh gateway b: every registry as a new process has it, the
        crash soak's settings, the controller on the device (its sim plane
        spawns), the local shard claimed by a server, ``boot_replay`` (a
        no-op on an empty state dir), the WAL writer started, the plane
        up; clients subscribed to its cells."""
        P, K, size = self.P, self.K, self.size
        reset_gateway(P)
        P.federation.reset_federation()
        P.failover.reset_failover()
        # Trace ids ride the trunk messages: a new process numbers them from 1,
        # under its pid, here the incarnation's (one leg may run in a child).
        P.tracing._trace_counter = counter = itertools.count(1)
        pid = 0xB00 + len(self.replays) + (t > 0)
        for module in self.traced:
            module.new_trace_id = \
                lambda prefix="", _c=counter, _p=pid: f"{prefix or 'g'}-{_p:x}-{next(_c):x}"
        p = self.p
        fed_pins(P, FedSoakParams(heartbeat_ms=p.heartbeat_ms, trunk_timeout_ms=p.trunk_timeout_ms,
                                  handover_timeout_ms=p.handover_timeout_ms,
                                  global_tick_ms=p.global_tick_ms))
        s = P.settings.global_settings
        wal_settings_hook("b", self.state_dir, p)(s)
        if P.port:
            s.spatial_device = self.dev.type
        s.tpu_entity_capacity = size["entity_capacity"]
        s.tpu_query_capacity = size["query_capacity"]
        s.sim_enabled = True
        s.sim_agents = size["agents"]
        s.sim_census_every_ticks = CRASH_CENSUS_EVERY
        s.device_guard_enabled = True
        s.device_step_deadline_s = size["deadline_s"]
        P.message.init_message_map()
        P.channel.init_channels()
        P.sim_models.register_sim_types()
        P.controller.init_spatial_controller(self.config)
        ctl = self.ctl = P.controller.get_spatial_controller()
        self.eng = ctl.engine
        if P.port:
            check(self.eng.device.type == self.dev.type,
                  f"the engine is on {self.eng.device}, not {self.dev}")
        P.federation.init_federation(fed_config(CRASH_PORTS), "b", ctl)
        self.plane, self.control = P.federation.plane, P.federation.control
        self.directory = P.federation.directory
        self.tap = TrunkTap("a")
        self.plane.manager = NS(links={"a": self.tap}, stop=lambda: None)
        self.tap.alive = False  # the trunk dials once the plane is up
        self.conns = []
        self._servers()
        self.metrics0 = P.invariants.scrape()  # before any WAL or replay counter moves
        t0 = time.perf_counter()
        rep = P.wal.boot_replay(self.snap_path, self.wal_path)
        rep["replay_s"] = time.perf_counter() - t0
        P.wal.wal.start(self.wal_path, initial_seq=rep.get("max_seq", 0))
        self.writer_seq0 = P.wal.wal.current_seq()
        self.plane.active = True
        self.control.plane, self.control.active = self.plane, True  # the epoch runs on the clock
        self._clients()
        self.gch = P.channel.get_global_channel()
        self.booted_at = t
        self.replay = rep
        self._wrap()

    def _servers(self) -> None:
        P, ctl = self.P, self.ctl
        master = self.conn(1, "SERVER")
        gch = P.channel.get_global_channel()
        gch.set_owner(master)
        P.sub.subscribe_to_channel(master, gch, None)
        server = self.conn(2, "SERVER")
        ctx = P.message.MessageContext(msg_type=P.types.MessageType.CREATE_CHANNEL,
                                       msg=P.control_pb2.CreateChannelMessage(), connection=server)
        for ch in ctl.create_channels(ctx):
            P.sub.subscribe_to_channel(server, ch, None)
        start = P.settings.global_settings.spatial_channel_id_start
        self.b_cells = [start + i for i in CRASH_CELLS["b"]]
        local = sorted(c for c, ch in P.channel.all_channels().items()
                       if ch.channel_type == P.types.ChannelType.SPATIAL)
        check(local == self.b_cells, f"16a: b's local cells {[hex(c) for c in local]}")

    def _clients(self) -> None:
        P = self.P
        for i in range(4):
            client = self.conn(2000 + i, "CLIENT")
            for cid in self.b_cells[2 * i:2 * i + 2]:
                P.sub.subscribe_to_channel(client, P.channel.get_channel(cid),
                                           P.control_pb2.ChannelSubscriptionOptions(
                                               fanOutIntervalMs=50))

    def _entities(self) -> list:
        """b's base population (the soak's ``spawn``: FedSim in x > 0), tracked
        on the device from birth; stub a's own base population."""
        P, ctl = self.P, self.ctl
        sim = FedSim(P, ctl, self.rng)
        sim.create_entities(self.size["entities"], *CRASH_XR["b"], *CRASH_ZR, base=CRASH_BASE["b"])
        for eid in sim.entity_ids:
            pos = P.channel.get_channel(eid).get_data_message().state.transform.position
            ctl.track_entity(eid, P.controller.SpatialInfo(pos.x, 0, pos.z))
        estart = P.settings.global_settings.entity_channel_id_start
        stub = self.stub
        for i in range(self.size["entities"]):
            eid = estart + 1 + CRASH_BASE["a"] + i
            stub.own.append(eid)
            stub.census.add(eid)
            stub.pos[eid] = (stub.rng.uniform(*CRASH_XR["a"]), stub.rng.uniform(*CRASH_ZR))
        return sim.entity_ids

    def _sensors(self) -> list:
        """Standing sensors over b's half (box, sphere, cone, spots),
        journaled as the WAL's query records."""
        ctl, ops, rng = self.ctl, self.P.ops, self.rng
        (x0, x1), (z0, z1) = CRASH_XR["b"], CRASH_ZR
        kinds = (ops.AOI_BOX, ops.AOI_SPHERE, ops.AOI_CONE, ops.AOI_SPOTS)
        for i in range(self.size["sensors"]):
            kind = kinds[i % 4]
            cx, cz = rng.uniform(x0, x1), rng.uniform(z0, z1)
            if kind == ops.AOI_SPOTS:
                ctl.register_sensor(f"b-sensor{i}", kind=kind, spots=[
                    (cx, cz), (rng.uniform(x0, x1), rng.uniform(z0, z1))], dists=[0, 1])
            else:
                ctl.register_sensor(f"b-sensor{i}", kind=kind, center=(cx, cz),
                                    extent=(rng.uniform(30, 70), rng.uniform(30, 70)),
                                    direction=(-1.0, 0.0), angle=0.7)
        return self.sensor_rows()

    def sensor_rows(self) -> list:
        """The query plane's rows, their parameters as the WAL's float32."""
        return sorted((key, scope, name, kind, np.float32(params).tolist(), list(spots))
                      for key, scope, name, kind, params, spots
                      in self.ctl.queryplane.snapshot_rows())

    def trunk_up(self) -> None:
        """The trunk between b and the stub comes up: the stub's side first
        (its notices and, after a death, the directory sync), then b's."""
        self.tap.alive = True
        self.stub.connect(self.tap)
        self.plane._on_trunk_up("a", self.tap)

    # ---- the kill and the restart ----------------------------------------

    def kill(self, t: int) -> None:
        """SIGKILL: the writer stops without a flush and the file keeps only
        what the last flush made durable; every registry, the engine and its
        tensors go with the process."""
        P = self.P
        wal = P.wal.wal
        self.kills.append(self.books(f"kill at tick {t}"))
        wal.stop(flush=False)
        with open(self.wal_path, "r+b") as f:
            f.truncate(self.flushed)
        with open(self.wal_path, "rb") as f:
            wal_bytes = f.read()
        self.kills[-1]["wal"] = (len(wal_bytes), hashlib.sha256(wal_bytes).hexdigest())
        self.kills[-1]["snapshot"] = self.snapshot_digest()
        with open(self.snap_path, "rb") as f:
            self.durable.append(dict(wal=wal_bytes, snapshot=f.read()))
        self.stub.disconnect(t)
        self._unwrap()
        self.tap.alive = False
        P.chaos.disarm()
        reset_gateway(P)
        P.federation.reset_federation()
        P.failover.reset_failover()
        self.ctl = self.eng = None
        if self.K is not None:
            self.K._zeroed.clear()  # K1's counts buffers go with the process
        gc.collect()  # the old engine's tensors sit in reference cycles
        self.down = True
        self.note_memory(f"kill at tick {t}")

    def restart(self, t: int) -> None:
        self.note_memory(f"before restart at tick {t}")
        t0 = time.perf_counter()
        self.boot(t)
        self.restarts.append(time.perf_counter() - t0)
        self.replays.append(dict(self.replay))
        self.booted.append(self.booted_state())
        self.down = False
        self.note_memory(f"after restart at tick {t}")

    def booted_state(self) -> dict:
        """What a restart's replay leaves for the device's first tick: the
        agents' host columns and sim tick, and the previous cell seeded for
        each of b's humans."""
        eng = self.eng
        slots = eng.agent_slots()
        return dict(ids=eng.agent_ids(slots).tolist(), sim_tick=int(eng.sim_tick),
                    columns=[c[slots].tolist() for c in (eng._positions, eng._vel,
                                                         eng._sim_state, eng._sim_target)],
                    prev_cells={int(eng._entity_of_slot[slot]): int(cell)
                                for slot, cell in eng._seed_cells.items()
                                if not eng._agent_mask[slot]})

    def note_memory(self, moment: str) -> None:
        if self.dev.type == "cuda":
            self.memory.append((moment, torch.cuda.memory_allocated(self.dev)))

    def settle(self, t: int) -> None:
        """The end of a tick b served: the durability barrier (every record
        appended so far fsync'd), then its snapshot loop's cycle when due
        (scripts/crash_soak.py's ``snapshot_loop``: take, write, checkpoint),
        the live writer left to carry the checkpoint out. The harness only
        waits for what the writer does to reach the disk: the checkpoint's
        rewrite (a new file) when it covers a record, and after a tear the
        torn prefix; the file's length is then what a kill keeps."""
        import os

        P = self.P
        wal = P.wal.wal
        wal_barrier(wal, self.writer_seq0)
        since = t - self.booted_at
        if since and since % CRASH_SNAPSHOT_TICKS == 0:
            snap = P.snapshot.take_snapshot()
            P.snapshot.write_snapshot(snap, self.snap_path)
            records, _ = P.wal.read_wal_records(self.wal_path, truncate=False)
            covered = any(r.seq <= snap.walSeq for r in records)
            inode = os.stat(self.wal_path).st_ino
            wal.checkpoint(snap.walSeq)
            if covered and wal.writer_alive():
                wal_wait("rewrite the file at the checkpoint",
                         lambda: os.stat(self.wal_path).st_ino != inode)
        if not wal.writer_alive() and not self.torn:
            # The tear's prefix is the last write that ever reaches the disk.
            wal_wait("write the torn prefix",
                     lambda: P.wal.read_wal_records(self.wal_path, truncate=False)[1])
            self.torn = True
        self.flushed = os.path.getsize(self.wal_path)

    def snapshot_digest(self):
        """The snapshot file's content (its wall-clock ``takenAt`` masked)."""
        import os

        if not os.path.exists(self.snap_path):
            return None
        snap = self.P.snapshot.load_snapshot(self.snap_path)
        return (snap.walSeq, self.P.snapshot.snapshot_digest(snap))

    def wal_digest(self):
        """The WAL's durable prefix: what the last flush made durable (on a
        kill tick the writer may still be writing the lost window)."""
        with open(self.wal_path, "rb") as f:
            blob = f.read(self.flushed)
        return (len(blob), hashlib.sha256(blob).hexdigest()[:16])

    # ---- the script ------------------------------------------------------

    def cell_of(self, x: float, z: float) -> int:
        return self.ctl.get_channel_id(self.P.controller.SpatialInfo(x, 0, z))

    def centre(self, cid: int) -> tuple:
        info = self.ctl._cell_center(cid - self.P.settings.global_settings.spatial_channel_id_start)
        return info.x, info.z

    def move(self, eid: int, x: float, z: float) -> None:
        FedSim(self.P, self.ctl, self.rng).move(eid, x, z)

    def west(self, n: int) -> list:
        """``n`` of b's live base entities moved into a's half."""
        P = self.P
        ids = [e for e in self.entity_ids if P.channel.get_channel(e) is not None
               and e not in self.plane._parked and self.eng.slot_of_entity(e) is not None][:n]
        check(len(ids) == n, f"16a: {len(ids)} of {n} of b's entities to move west")
        for eid in ids:
            self.move(eid, self.rng.uniform(*CRASH_XR["a"]), self.rng.uniform(*CRASH_ZR))
        return ids

    def drive(self, t: int) -> None:
        at, size, stub = CRASH_AT, self.size, self.stub
        stub.answer()
        if t == at["trunk1"] or t == at["trunk2"]:
            self.trunk_up()
        since = t - self.booted_at
        if since and since % CRASH_SWEEP_TICKS == 0:
            fed_timeouts(self.plane)
        if t == at["commit_in"]:
            self.commit_in = stub.herd(size["commits"], t)
        elif t == at["commit_out"]:
            self.commit_out = self.west(size["commits"])
        elif t == at["burst1"]:
            stub.hold = True  # b's acks stay on the wire from here to the kill
            self.burst1 = stub.herd(size["burst"] // 2, t)
            self.applied_copy = [e for rows in stub.pending.values() for e, _, _ in rows]
        elif t == at["kill1"]:
            self.burst1 += stub.herd(size["burst"] - len(self.burst1), t)
        elif t == at["restart1"]:
            self.parked = self.west(size["parked"])  # crossings before the trunk is up
        elif t == at["reoffer"]:
            self.reoffered = stub.reoffer()
        elif t == at["torn"]:
            # scripts/crash_soak.py's arm_torn: the next append tears (simulated
            # power loss) and the writer wedges; the marker is that append.
            self.P.chaos.arm({"seed": self.p.seed, "faults": [
                {"point": "wal.torn_write", "every_n": 1, "max_fires": 1}]})
            self.P.wal.wal.log_flip([], 0)
        elif t == at["burst2"]:
            stub.hold = True
            self.burst2 = stub.herd(size["burst"] // 2, t)
        elif t == at["kill2"]:
            self.burst2 += stub.herd(size["burst"] - len(self.burst2), t)

    def stub_tick(self, t: int) -> None:
        if t % CRASH_EPOCH_TICKS == 0:
            self.stub.epoch_tick(t)

    # ---- the events ------------------------------------------------------

    def expect(self, name: str, ok, detail="") -> None:
        self.events.append((name, bool(ok), str(detail)[:300]))

    def in_cell(self, eid: int, cid) -> bool:
        ch = self.P.channel.get_channel(cid) if cid is not None else None
        return ch is not None and eid in ch.get_data_message().entities

    def placed(self) -> dict:
        """b's placement: entity id -> [cells holding it]."""
        P, out = self.P, {}
        for cid, ch in P.channel.all_channels().items():
            if ch.channel_type == P.types.ChannelType.SPATIAL:
                for eid in ch.get_data_message().entities:
                    out.setdefault(eid, []).append(cid)
        return out

    def at_centres(self, ids) -> list:
        """Those of ``ids`` tracked on the card at the centre of the cell
        holding them, the placement ledger agreeing."""
        eng, ctl = self.eng, self.ctl
        out = []
        for e in ids:
            cid, slot = ctl._data_cell.get(e), eng.slot_of_entity(e)
            if slot is not None and self.in_cell(e, cid) \
                    and tuple(eng._positions[slot][[0, 2]]) == self.centre(cid):
                out.append(e)
        return out

    def gone(self, ids) -> list:
        """Those of ``ids`` with no channel, no slot and no row on b."""
        P, placed = self.P, self.placed()
        return [e for e in ids if P.channel.get_channel(e) is None
                and self.eng.slot_of_entity(e) is None and e not in placed]

    def restart_checks(self, k: int) -> None:
        """A restart's boot, before its first tick: every resident of b's
        cells re-tracked at its cell's centre (the placement ledger naming
        that cell), the sensor rows and the sim census restored."""
        eng, ctl, rep = self.eng, self.ctl, self.replay
        humans = [e for e in self.placed() if e < self.agent_base]
        self.expect(f"restart_{k}_residents_retracked_at_cell_centres",
                    humans and self.at_centres(humans) == humans,
                    (len(self.at_centres(humans)), len(humans)))
        self.expect(f"restart_{k}_sensor_rows_restored", self.sensor_rows() == self.sensor_keys,
                    (len(self.sensor_rows()), len(self.sensor_keys)))
        census, booted = self.durable_census, self.booted[-1]
        journaled = journaled_census(self.P, self.durable[-1]["wal"], self.durable[-1]["snapshot"])
        self.expect(f"restart_{k}_sim_census_restored",
                    census is not None and ctl.simplane.ledgers.get("agents_restored") == census[0]
                    and eng.sim_tick == census[1]
                    and sorted(eng.agent_ids().tolist()) == census[2]
                    and journaled is not None and booted_agents(booted) == journaled,
                    (census and census[:2], ctl.simplane.ledgers, eng.sim_tick,
                     journaled and journaled[:2]))
        self.expect(f"restart_{k}_replayed_snapshot_and_wal",
                    rep["snapshot_channels"] > 0 and rep["wal_records"] > 0, rep)

    def check_events(self, t: int) -> None:
        at, P, eng, plane, stub = CRASH_AT, self.P, self.eng, self.plane, self.stub
        if t == at["commit_in"] + 2:
            self.expect("inbound_commit_tracked_at_cell_centres",
                        self.at_centres(self.commit_in) == self.commit_in
                        and not stub.pending and len(self.commit_in) == self.size["commits"],
                        (self.at_centres(self.commit_in), self.commit_in))
        if t == at["commit_out"] + 3:
            self.expect("outbound_commit_untracked",
                        self.gone(self.commit_out) == self.commit_out
                        and set(self.commit_out) <= stub.census, self.commit_out)
        if t == at["trunk1"] + 2:
            self.expect("reclaimed", self.control.resurrections == {"announced": 1, "reclaimed": 1}
                        and stub.resurrections == {"peer_reclaimed": 1},
                        (self.control.resurrections, stub.resurrections))
            self.expect("abort_notices_purged_the_applied_copy",
                        plane.ledger.get("reconciled", 0) == len(self.applied_copy) > 0
                        and all(P.channel.get_channel(e) is None for e in self.applied_copy),
                        (plane.ledger, self.applied_copy))
            self.expect("parked_crossings_reoffered_from_the_card_and_committed",
                        self.gone(self.parked) == self.parked and set(self.parked) <= stub.census,
                        self.parked)
        if t == at["reoffer"] + 2:
            self.expect("stub_burst_reoffered_and_committed",
                        self.at_centres(self.reoffered) == self.reoffered
                        and sorted(self.reoffered) == sorted(self.burst1) and not stub.pending,
                        (self.reoffered, self.burst1))
        if t == at["torn"]:
            wal = P.wal.wal
            self.expect("wal_torn_and_writer_wedged", self.torn and wal.enabled
                        and not wal.writer_alive(), wal.report())
        if self.yield_at is None and self.control.resurrections.get("yielded"):
            self.yield_at = t
            self.yield_missing = next(e[3] for e in reversed(stub.log) if e[0] == "hello")
            dropped = self.yield_event()["dropped_ids"]
            self.expect("yield_dropped_copies_leave_the_card_in_the_same_tick",
                        dropped and self.gone(dropped) == dropped
                        and not any(eng.is_agent(e) for e in dropped), dropped)
            self.kernels_at("yield")
        if self.yield_at is not None and t == self.yield_at + 3:
            handed = self.yield_missing
            self.expect("yield_missing_ids_handed_over_the_trunk",
                        handed and self.gone(handed) == handed and set(handed) <= stub.census
                        and self.control.counters.get("resurrect_entities_handed") == len(handed),
                        (handed, self.control.counters))
            self.expect("yielded", self.control.resurrections == {"announced": 1, "yielded": 1}
                        and stub.resurrections.get("peer_yielded") == 1,
                        (self.control.resurrections, stub.resurrections))

    def yield_event(self) -> dict:
        return next(e for e in self.control.events if e.get("kind") == "resurrect_yield_shard")

    def kernels_at(self, case: str) -> None:
        eng, K = self.eng, self.K
        self.kernels[case] = None if K is None else soak_live_kernels(
            K, eng.grid, eng._d_positions, eng._d_valid, eng._d_queries)

    # ---- one tick ----------------------------------------------------------

    def tick(self, t: int) -> dict:
        P, K, at = self.P, self.K, CRASH_AT
        self.clock.advance(CRASH_TICK_S)
        self.stub_tick(t)
        if t in (at["restart1"], at["restart2"]):
            k = 1 if t == at["restart1"] else 2
            self.restart(t)
            self.restart_checks(k)
            if k == 2:
                self.expect("restart_2_torn_tail_truncated", self.replay["torn"], self.replay)
        if self.down:
            return dict(down=True)
        eng, ctl = self.eng, self.ctl
        sent0 = len(self.tap.sent)
        self.drive(t)
        self.censuses_at_tick = P.wal.wal.record_counts.get("sim_census", 0)
        now = time.monotonic_ns()
        chans = P.channel.all_channels()
        cuda = self.dev.type == "cuda"
        crossings, ran, steps = len(self.handovers), self.engine_ticks, len(self.step_ms)
        before = K.launch_counts() if K is not None else None
        estart = P.settings.global_settings.entity_channel_id_start
        entity_channels = [ch for cid, ch in sorted(chans.items()) if cid >= estart]
        spatial = [ch for cid, ch in sorted(chans.items())
                   if ch.channel_type == P.types.ChannelType.SPATIAL]
        sync(self.dev)
        eng.last_result = None
        with (Reads() if cuda else contextlib.nullcontext()) as reads:
            t0 = time.perf_counter()
            for ch in entity_channels:
                ch.tick_once(now)
            self.gch.tick_once(now)
            for ch in spatial:
                ch.tick_once(now)
            t1 = time.perf_counter()
        result = eng.last_result
        first = t in (at["restart1"], at["restart2"])
        if first and K is not None:
            self.kernels_at(f"restart{1 if t == at['restart1'] else 2}")
        if first:
            self.restarts[-1] += time.perf_counter() - t0  # restart to serving: boot + first tick
        kill = t in (at["kill1"], at["kill2"])
        censuses = P.wal.wal.record_counts.get("sim_census", 0)
        if not kill:
            self.settle(t)
            if censuses > self.censuses_at_tick and not self.torn:
                slots = eng.agent_slots()
                self.durable_census = (len(slots), eng.sim_tick,
                                       sorted(eng.agent_ids(slots).tolist()))
        obs = dict(handovers=[r for rows in self.handovers[crossings:] for r in rows],
                   ran=self.engine_ticks - ran, served=result is not None,
                   tick_ms=(t1 - t0) * 1e3,
                   step_ms=self.step_ms[steps] if len(self.step_ms) > steps else None,
                   reads=reads.count if cuda else None)
        obs.update(self.observe(result, sent0))
        if K is not None:
            obs["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
        if self.size.get("columns"):
            slots = np.sort(eng.agent_slots())
            self.columns.append([host(c)[slots] for c in (eng._d_positions, eng._d_vel,
                                                          eng._d_sim_state, eng._d_sim_target)])
        self.placed_ever.update(self.placed())
        self.check_events(t)
        if kill:
            pending = sorted(self.stub.pending)
            self.kill(t)
            self.expect(f"kill_{1 if t == at['kill1'] else 2}_in_flight_batches_aborted_at_the_stub",
                        pending and set(pending) <= self.stub.notices
                        and not self.stub.pending, (pending, sorted(self.stub.notices)))
            if t == at["kill2"]:
                self.stub.death_ticks = round(
                    self.p.death_miss_epochs * self.p.epoch_ms / 1000.0 / CRASH_TICK_S)
            self.stub.hold = False
        return obs

    def observe(self, result, sent0: int) -> dict:
        """Digests of what the tick left on b (as FleetWorld's), the WAL's
        bytes after the tick's flush, the snapshot, and the stub's holdings."""
        P, eng, ctl = self.P, self.eng, self.ctl
        tables, agent_rows = hashlib.sha256(), hashlib.sha256()
        for cid, ch in sorted(P.channel.all_channels().items()):
            if ch.channel_type == P.types.ChannelType.SPATIAL:
                for eid, state in sorted(ch.get_data_message().entities.items()):
                    h = agent_rows if eid >= self.agent_base else tables
                    h.update(np.array([cid, eid], np.int64).tobytes())
                    h.update(state.SerializeToString(deterministic=True))
        q = counts = None
        census = False
        if result is not None:
            count, rows = eng.query_changed_rows(result)
            q = (count, digest([rows[: min(count, len(rows))]])[0])
            census = "sim_census" in result
            counts = digest([np.asarray(eng.consume(result)[2] if hasattr(eng, "consume")
                                        else result["cell_counts"])])[0]
        slots = sorted(eng._slot_of_entity.items())
        engine = digest([np.asarray(slots, np.int64).reshape(-1), host(eng._d_cell),
                         host(eng._d_valid), eng._agent_mask])
        sim = digest([host(t) for t in (eng._d_positions, eng._d_vel, eng._d_sim_state,
                                        eng._d_sim_target)]) if eng._d_vel is not None else None
        trunk = [(tp, len(b), hashlib.sha256(b).hexdigest()[:16])
                 for tp, b, _ in self.tap.sent[sent0:]]
        wal = P.wal.wal
        raw = None
        if self.size.get("columns"):
            # What the digests fold, for a comparison with JAX that parses them.
            with open(self.wal_path, "rb") as f:
                blob = f.read(self.flushed)
            raw = dict(trunk=[(tp, b) for tp, b, _ in self.tap.sent[sent0:]], wal=blob,
                       frames={c.id: c.frames for c in self.conns},
                       agent_rows=[(cid, eid, state.SerializeToString(deterministic=True))
                                   for cid, ch in sorted(P.channel.all_channels().items())
                                   if ch.channel_type == P.types.ChannelType.SPATIAL
                                   for eid, state in sorted(ch.get_data_message().entities.items())
                                   if eid >= self.agent_base])
            for c in self.conns:
                c.frames = []
        return dict(raw=raw,
            tables=tables.hexdigest(), agent_rows=agent_rows.hexdigest(), q=q, census=census,
            counts=counts, engine=engine, sim=sim,
            placement=digest([np.asarray(sorted(ctl._data_cell.items()), np.int64).reshape(-1)])[0],
            agents=(eng.agent_count(), sorted(ctl.simplane.authority._backed)),
            trunk={"a": trunk},
            ledgers=(sorted(self.plane.ledger.items()), sorted(self.control.resurrections.items()),
                     sorted(self.control.counters.items()), sorted(wal.record_counts.items()),
                     sorted(wal.replay_counts.items()), wal.current_seq(),
                     sorted(ctl.simplane.ledgers.items()),
                     sorted(ctl.simplane.authority.ledgers.items()),
                     sorted(ctl.queryplane.ledgers.items()),
                     sorted(P.failover.journal.counts.items())),
            peers={"a": sorted(self.stub.census)},
            wal=self.wal_digest(), snapshot=self.snapshot_digest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns})

    def run(self) -> list:
        self.agent_base = self.P.settings.global_settings.entity_channel_id_start \
            + self.P.sim_plane.AGENT_ID_OFFSET
        self.yield_at = None
        return [self.tick(t) for t in range(self.size["ticks"])]

    # ---- the books ---------------------------------------------------------

    def books(self, when: str) -> dict:
        """b's ledgers against their metrics since this incarnation booted
        (scripts/crash_soak.py's ``wal_metric_delta``)."""
        P = self.P
        inv = P.invariants
        metric: dict = {"records": {}, "replayed": {}, "resurrection": {}}
        for (name, labels), value in inv.delta(inv.scrape(), self.metrics0).items():
            if not value:
                continue
            if name == "wal_records_total":
                metric["records"][dict(labels)["kind"]] = int(value)
            elif name == "wal_replayed_total":
                metric["replayed"][dict(labels)["kind"]] = int(value)
            elif name == "resurrection_total":
                metric["resurrection"][dict(labels)["outcome"]] = int(value)
        wal = P.wal.wal
        return dict(when=when, metric=metric, records=dict(wal.record_counts),
                    replayed=dict(wal.replay_counts),
                    resurrections=dict(self.control.resurrections))

    def report(self) -> dict:
        """The books at the end: the census across b and the stub, the
        ledgers against their metrics at each kill and at the end, the
        journal, nothing left in flight."""
        P = self.P
        placed = {e: [("b", c) for c in cids] for e, cids in self.placed().items()}
        for e in self.stub.census:
            placed.setdefault(e, []).append(("a", 0))
        expected = set(self.entity_ids) | set(self.stub.own) | self.placed_ever
        s = P.settings.global_settings
        return dict(
            lost=sorted(e for e in expected if e not in placed),
            duplicated={e: w for e, w in placed.items() if len(w) > 1},
            books=self.kills + [self.books("end")],
            journal=dict(P.failover.journal.counts),
            in_flight=P.failover.journal.in_flight_count(),
            pending=(len(self.plane._pending), len(self.plane._parked), len(self.stub.pending)),
            replays=[{k: v for k, v in r.items() if k not in ("elapsed_s", "replay_s")}
                     for r in self.replays],
            replay_s=[r["replay_s"] for r in self.replays], restart_s=list(self.restarts),
            deadlines=(s.wal_restart_deadline_s, self.p.restart_deadline_s),
            kills=[{k: v for k, v in b.items() if k in ("wal", "snapshot")} for b in self.kills],
            ledger=dict(self.plane.ledger), control=dict(self.control.counters),
            resurrections=dict(self.control.resurrections), stub=dict(self.stub.resurrections),
            stub_log=list(self.stub.log), sim=dict(self.ctl.simplane.ledgers),
            yield_at=self.yield_at, kernels=self.kernels, engine_ticks=self.engine_ticks,
            memory=list(self.memory), durable=list(self.durable), booted=list(self.booted),
            census=(len(placed), len(self.placed()),
                                              len(self.stub.census)))

    def close(self) -> None:
        P = self.P
        P.chaos.disarm()
        P.federation.reset_federation()
        for module, fn in zip(self.traced, self.trace_ids):
            module.new_trace_id = fn
        self._unwrap()
        reset_gateway(P)
        P.failover.reset_failover()


def journaled_census(P, wal_bytes: bytes, snapshot_bytes: bytes):
    """The census a restart replays, decoded by ``P``'s WAL and snapshot
    readers from the files a kill left: the last ``sim_census`` record
    above the snapshot's sequence, as (sim tick, ids, [positions,
    velocities, states, targets] by id), or None."""
    import tempfile

    snap = P.snapshot.snapshot_pb2.GatewaySnapshot()
    snap.ParseFromString(snapshot_bytes)
    with tempfile.NamedTemporaryFile(suffix=".wal") as f:
        f.write(wal_bytes)
        f.flush()
        records, _ = P.wal.read_wal_records(f.name, truncate=False)
    census = [r for r in records if r.kind == "sim_census" and r.seq > snap.walSeq]
    if not census:
        return None
    r = census[-1]
    n = len(r.simAgentIds)
    order = np.argsort(np.asarray(r.simAgentIds, np.int64), kind="stable")
    cols = [np.asarray(r.simAgentPos, np.float32).reshape(n, 3),
            np.asarray(r.simAgentVel, np.float32).reshape(n, 3),
            np.asarray(r.simAgentState, np.int32),
            np.asarray(r.simAgentTarget, np.float32).reshape(n, 3)]
    return (int(r.simTick), np.asarray(r.simAgentIds, np.int64)[order].tolist(),
            [c[order].tolist() for c in cols])


def booted_agents(booted: dict) -> tuple:
    """``CrashWorld.booted_state()``'s agents in ``journaled_census``'s
    form."""
    order = np.argsort(np.asarray(booted["ids"], np.int64), kind="stable")
    return (booted["sim_tick"], np.asarray(booted["ids"], np.int64)[order].tolist(),
            [np.asarray(c)[order].tolist() for c in booted["columns"]])


def crash_config(scratch: str) -> str:
    """WORLD_SPATIAL on the device controller, as a spatial config file."""
    import os

    path = os.path.join(scratch, "crash_world.json")
    with open(path, "w") as f:
        json.dump(dict(WORLD_SPATIAL, SpatialControllerType="TPUSpatialController"), f)
    return path


def run_crash_leg(P, dev: torch.device, size: dict, scratch: str, K=None) -> tuple:
    """One leg of 16a in a state dir of its own: (per-tick observations,
    report with the events' checks and, with ``K``, the kernels on the
    live tensors at each restart's first tick and the yield tick)."""
    import os
    import tempfile

    t_leg = time.perf_counter()
    state_dir = tempfile.mkdtemp(prefix=f"crash-{dev.type}-", dir=scratch)
    with FixedClock() as clock:
        if K is not None:
            K.reset_launch_counts()
        world = CrashWorld(P, dev, clock, size, state_dir, crash_config(scratch), K)
        obs = world.run()
        report = world.report()
        report["events"] = list(world.events)
        report["columns"] = world.columns
        report["launches"] = K.launch_counts() if K is not None else None
        world.close()
        del world
    report["secs"] = time.perf_counter() - t_leg
    report["state_dir"] = os.path.basename(state_dir)
    return obs, report


def crash_checks(obs: list, r: dict) -> list:
    """16a's books of one leg, as (name, held, detail): the events, the
    census across b and the stub (zero lost, zero duplicated), each of b's
    ledgers equal to its metric at each kill and at the end, the journal
    balanced, nothing left in flight, every tick b was up served, each
    restart within the deadlines."""
    out = list(r["events"])
    out += [("census_zero_lost", r["lost"] == [], r["lost"]),
            ("census_zero_duplicated", r["duplicated"] == {}, r["duplicated"])]
    for name, ledger, metric in (("wal_records", "records", "records"),
                                 ("wal_replayed", "replayed", "replayed"),
                                 ("resurrection", "resurrections", "resurrection")):
        bad = [b["when"] for b in r["books"] if b["metric"][metric] != b[ledger]]
        out.append((f"{name}_ledger_equals_metric", not bad, bad))
    jc = r["journal"]
    out += [("journal_balanced", jc.get("prepared", 0) == jc.get("committed", 0)
             + jc.get("aborted", 0) and r["in_flight"] == 0, (jc, r["in_flight"])),
            ("nothing_pending_or_parked", r["pending"] == (0, 0, 0), r["pending"]),
            ("every_tick_up_served", all(o["served"] for o in obs if not o.get("down")),
             [t for t, o in enumerate(obs) if not o.get("down") and not o["served"]][:10]),
            ("restarts_within_deadline", len(r["restart_s"]) == 2
             and all(s <= r["deadlines"][1] for s in r["restart_s"])
             and all(s <= r["deadlines"][0] for s in r["replay_s"]),
             (r["restart_s"], r["replay_s"]))]
    return out


# ---- 16b: scripts/crash_soak.py's live two-process run through the port ------




async def run_crash_soak(P, p: CrashSoakParams, scratch: str) -> dict:
    """scripts/crash_soak.py's ``run_crash_soak`` through the port: gateway
    "a" in-process on this asyncio loop, gateway "b" a ``--crash-child``
    process of this script, SIGKILLed twice (once reclaimed, once adopted
    over a torn WAL tail) and restarted from its snapshot and WAL; both on
    the script's WORLD_SPATIAL, whose Static2DSpatialController touches no
    device. The phases, the invariants and the report under the script's
    names; the child's report also carries its foreign modules and its
    controller."""
    import asyncio
    import os
    import signal

    from random import Random

    journal = P.failover.journal
    gs = P.settings.global_settings
    t_start = time.monotonic()
    baseline = P.invariants.scrape()
    ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client"), fed_free_ports(4)))
    fed_cfg = fed_config(ports)
    state_dir = p.state_dir or os.path.join(scratch, "crash_soak_state")
    os.makedirs(state_dir, exist_ok=True)
    cfg_path = os.path.join(scratch, "crash_soak_cfg.json")
    b_report_path = os.path.join(scratch, "crash_soak_b.json")
    with open(cfg_path, "w") as f:
        json.dump(fed_cfg, f)
    here = os.path.dirname(os.path.abspath(__file__))

    def spawn_child(generation: int):
        t_spawn[generation] = time.perf_counter()
        with open(f"{b_report_path}.b{generation}.log", "w") as log:
            return subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--crash-child", cfg_path,
                 b_report_path, state_dir, str(p.seed + generation)],
                cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log, text=True)

    generation = 0
    t_spawn: dict = {}
    boots: dict = {}
    procs = [spawn_child(generation)]
    b = FedChild(procs[-1], t_spawn[generation])
    stop = asyncio.Event()
    gw = snap_task = None
    timeline: list = []
    notes: list = []
    crashes: list = []

    def mark(phase: str, **kw) -> None:
        timeline.append({"t": round(time.monotonic() - t_start, 2), "phase": phase, **kw})

    async def wait_trunk(plane, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and plane.link_to("b") is None:
            await asyncio.sleep(0.05)
        if plane.link_to("b") is None:
            raise PhaseFailed("16b: the trunk to b never (re-)established")

    async def kill_mid_burst(plane, sim, phase: str) -> dict:
        sim.adopt_scan()
        sim.herd(sim.local_ids()[: p.kill_burst], *CRASH_XR["b"], *CRASH_ZR)
        ev = dict(phase=phase, mid_burst=False, restart_s=0.0, replay={})
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if any(bt.peer == "b" for bt in plane._pending.values()):
                procs[-1].send_signal(signal.SIGKILL)
                ev["mid_burst"] = True
                break
            await asyncio.sleep(0)
        if not ev["mid_burst"]:
            procs[-1].send_signal(signal.SIGKILL)
            notes.append(f"{phase}: kill raced, no batch in flight")
        return ev

    async def restart_b(ev: dict) -> None:
        nonlocal b, generation
        with contextlib.suppress(subprocess.TimeoutExpired):
            procs[-1].wait(timeout=10)
        generation += 1
        t0 = time.monotonic()
        procs.append(spawn_child(generation))
        b = FedChild(procs[-1], t_spawn[generation])
        boots[f"b{generation}"] = child_boot(b, await b.wait_for("READY",
                                                                 p.child_boot_timeout_s))
        ev["restart_s"] = round(time.monotonic() - t0, 2)

    try:
        try:
            boots["b0"] = child_boot(b, await b.wait_for("READY", p.child_boot_timeout_s))
        except (RuntimeError, TimeoutError) as e:
            with open(f"{b_report_path}.b0.log") as f:
                tail = f.read()[-600:]
            raise PhaseFailed(f"16b: the --crash-child gateway did not boot ({e}): {tail}")
        sink_a: dict = {"replay": {}}
        fp = FedSoakParams(heartbeat_ms=p.heartbeat_ms, trunk_timeout_ms=p.trunk_timeout_ms,
                           handover_timeout_ms=p.handover_timeout_ms,
                           global_tick_ms=p.global_tick_ms)
        gw = await fed_boot_gateway(P, "a", fed_cfg, fp, stop, scratch,
                                    settings_hook=wal_settings_hook("a", state_dir, p),
                                    pre_start_hook=wal_pre_start_hook(P, "a", state_dir, sink_a))
        plane, ctl, control = gw["plane"], gw["ctl"], P.federation.control
        a_snap, _ = persistence_paths(state_dir, "a")
        snap_task = asyncio.ensure_future(P.snapshot.snapshot_loop(a_snap, p.snapshot_interval_s))
        await wait_trunk(plane, 15.0)
        mark("trunk_up", leader=control.leader())
        sim = FedSim(P, ctl, Random(p.seed ^ 0xA))
        sim.create_entities(p.base_entities, *CRASH_XR["a"], *CRASH_ZR, base=CRASH_BASE["a"])
        await b.cmd("spawn", n=p.base_entities)
        estart = gs.entity_channel_id_start
        expected_ids = {str(estart + 1 + CRASH_BASE[g] + i)
                        for g in ("a", "b") for i in range(p.base_entities)}

        async def wait_ledger(key: str, at_least: int, timeout: float) -> bool:
            end = time.monotonic() + timeout
            while time.monotonic() < end:
                if plane.ledger.get(key, 0) >= at_least:
                    return True
                await asyncio.sleep(0.05)
            return False

        sim.herd(sim.entity_ids[: p.committed_each_way], *CRASH_XR["b"], *CRASH_ZR)
        if not await wait_ledger("committed", p.committed_each_way, p.phase_timeout_s):
            notes.append("pre-crash a->b commits incomplete")
        await b.cmd("herd_to", gw="a", n=p.committed_each_way)
        if not await wait_ledger("applied", 1, p.phase_timeout_s):
            notes.append("pre-crash b->a handover never applied")
        await b.cmd("flush_wal")
        await asyncio.to_thread(P.wal.wal.flush)
        mark("traffic", committed=plane.ledger.get("committed", 0),
             applied=plane.ledger.get("applied", 0))

        if "reclaim" in p.phases:
            gs.global_death_miss_epochs = 100_000
            ev = await kill_mid_burst(plane, sim, "reclaim")
            crashes.append(ev)
            mark("sigkill_reclaim", mid_burst=ev["mid_burst"])
            deadline = time.monotonic() + p.phase_timeout_s
            while time.monotonic() < deadline and any(
                    bt.peer == "b" for bt in plane._pending.values()):
                await asyncio.sleep(0.1)
            await restart_b(ev)
            await wait_trunk(plane, p.phase_timeout_s)
            deadline = time.monotonic() + p.phase_timeout_s
            while time.monotonic() < deadline and \
                    control.resurrections.get("peer_reclaimed", 0) < 1:
                await asyncio.sleep(0.1)
            if control.resurrections.get("peer_reclaimed", 0) < 1:
                notes.append("no peer_reclaimed resurrection observed")
            deadline = time.monotonic() + p.phase_timeout_s
            while time.monotonic() < deadline and (plane._pending or plane._parked):
                await asyncio.sleep(0.1)
            await b.cmd("quiesce", timeout=p.phase_timeout_s + 5.0, drain_s=p.phase_timeout_s)
            await b.cmd("flush_wal")
            await b.cmd("report", timeout=15.0)
            with open(b_report_path) as f:
                ev["replay"] = json.load(f)["persistence"]["replay"]
            mark("reclaimed", restart_s=ev["restart_s"], replay_s=ev["replay"].get("elapsed_s"),
                 resurrections=dict(control.resurrections))

        if "adopt" in p.phases:
            gs.global_death_miss_epochs = p.death_miss_epochs
            await b.cmd("flush_wal")
            await b.cmd("arm_torn")
            ev = await kill_mid_burst(plane, sim, "adopt")
            crashes.append(ev)
            mark("sigkill_adopt", mid_burst=ev["mid_burst"])
            deadline = time.monotonic() + p.phase_timeout_s * 2
            while time.monotonic() < deadline and "b" not in control.dead:
                await asyncio.sleep(0.1)
            if "b" not in control.dead:
                raise PhaseFailed(f"16b: b never declared dead: {control.report()['counters']}")
            deadline = time.monotonic() + p.phase_timeout_s
            while time.monotonic() < deadline and control.adoptions < 1:
                await asyncio.sleep(0.1)
            mark("adopted_by_a", adoptions=control.adoptions, deaths=control.deaths)
            await restart_b(ev)
            await wait_trunk(plane, p.phase_timeout_s)
            deadline = time.monotonic() + p.phase_timeout_s
            while time.monotonic() < deadline and \
                    control.resurrections.get("peer_yielded", 0) < 1:
                await asyncio.sleep(0.1)
            if control.resurrections.get("peer_yielded", 0) < 1:
                notes.append("no peer_yielded resurrection observed")
            deadline = time.monotonic() + p.phase_timeout_s
            while time.monotonic() < deadline and (plane._pending or plane._parked):
                await asyncio.sleep(0.1)
            await b.cmd("quiesce", timeout=p.phase_timeout_s + 5.0, drain_s=p.phase_timeout_s)
            mark("yielded", restart_s=ev["restart_s"], resurrections=dict(control.resurrections))

        qdeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < qdeadline and (
                plane._pending or plane._parked or journal.in_flight_count()):
            await asyncio.sleep(0.1)
        await asyncio.sleep(p.quiesce_s)
        await b.cmd("report", timeout=15.0)
        with open(b_report_path) as f:
            b_report = json.load(f)
        final_replay = b_report["persistence"]["replay"]
        if crashes and not crashes[-1]["replay"]:
            crashes[-1]["replay"] = final_replay
        a_placement = fed_local_placement(P)
        b_placement = dict(b_report["placement"])
        local_dups_a = a_placement.pop("__local_dups__", [])
        local_dups_b = b_placement.pop("__local_dups__", [])
        a_persist = persistence_report(P, baseline, sink_a["replay"])

        inv = P.invariants.InvariantChecker()
        inv.expect_le("two_crashes", len(p.phases), len(crashes),
                      f"{len(crashes)} crashes, phases={p.phases}")
        inv.check("both_kills_mid_handover_burst", all(ev["mid_burst"] for ev in crashes),
                  str([(ev["phase"], ev["mid_burst"]) for ev in crashes]))
        if "reclaim" in p.phases:
            inv.expect_gt("shard_reclaimed_after_restart",
                          control.resurrections.get("peer_reclaimed", 0), 0)
        if "adopt" in p.phases:
            inv.check("death_declared_and_adopted", control.deaths >= 1 and control.adoptions >= 1,
                      f"deaths={control.deaths} adoptions={control.adoptions}")
            inv.expect_gt("shard_yielded_after_restart",
                          control.resurrections.get("peer_yielded", 0), 0)
            b_res = b_report["persistence"]["resurrections"]
            inv.expect_gt("b_counted_yielded", b_res.get("yielded", 0), 0, str(b_res))
            inv.check("torn_tail_replayed", bool(final_replay.get("torn")), str(final_replay))
        counts: dict = {}
        for eid, cell in a_placement.items():
            counts.setdefault(eid, []).append(("a", cell))
        for eid, cell in b_placement.items():
            counts.setdefault(eid, []).append(("b", cell))
        missing = sorted(e for e in expected_ids if e not in counts)
        duplicated = {e: w for e, w in counts.items() if len(w) > 1}
        unexpected = sorted(e for e in counts if e not in expected_ids)
        inv.expect_equal("zero_committed_entities_lost_or_duplicated",
                         (missing, duplicated, unexpected, local_dups_a, local_dups_b),
                         ([], {}, [], [], []))
        replay_ok = all((c["replay"] or final_replay).get("elapsed_s", 1e9)
                        <= gs.wal_restart_deadline_s for c in crashes)
        inv.check("replay_within_deadline", replay_ok, str([final_replay.get("elapsed_s")]))
        inv.check("restart_to_serving_within_deadline",
                  all(0 < c["restart_s"] <= p.restart_deadline_s for c in crashes),
                  str([(c["phase"], c["restart_s"]) for c in crashes]))
        inv.expect_equal("a_wal_records_ledger_matches_metric", a_persist["metric"]["records"],
                         a_persist["wal"]["record_counts"])
        inv.expect_equal("a_wal_replayed_ledger_matches_metric", a_persist["metric"]["replayed"],
                         a_persist["wal"]["replay_counts"])
        inv.expect_equal("a_resurrection_ledger_matches_metric",
                         a_persist["metric"]["resurrection"], a_persist["resurrections"])
        b_persist = b_report["persistence"]
        inv.expect_equal("b_wal_records_ledger_matches_metric", b_persist["metric"]["records"],
                         b_persist["wal"]["record_counts"])
        inv.expect_equal("b_wal_replayed_ledger_matches_metric", b_persist["metric"]["replayed"],
                         b_persist["wal"]["replay_counts"])
        inv.expect_equal("b_resurrection_ledger_matches_metric",
                         b_persist["metric"]["resurrection"], b_persist["resurrections"])
        inv.expect_equal("nothing_left_in_flight",
                         (len(plane._pending), len(plane._parked), b_report["pending"],
                          b_report["parked"], journal.in_flight_count()), (0, 0, 0, 0, 0))
        jc = dict(journal.counts)
        inv.expect_equal("journal_prepared_equals_committed_plus_aborted", jc.get("prepared", 0),
                         jc.get("committed", 0) + jc.get("aborted", 0), f"counts={jc}")
        report = {
            "kind": "crash_soak", "duration_s": round(time.monotonic() - t_start, 2),
            "entities": len(expected_ids),
            "knobs": {"fsync_ms": p.fsync_ms, "snapshot_interval_s": p.snapshot_interval_s,
                      "epoch_ms": p.epoch_ms, "death_miss_epochs": p.death_miss_epochs,
                      "restart_deadline_s": p.restart_deadline_s,
                      "wal_restart_deadline_s": gs.wal_restart_deadline_s},
            "timeline": timeline,
            "crashes": [{"phase": c["phase"], "mid_burst": c["mid_burst"],
                         "restart_s": c["restart_s"],
                         "replay_s": (c["replay"] or {}).get("elapsed_s"),
                         "torn": bool((c["replay"] or {}).get("torn"))} for c in crashes],
            "replay": final_replay,
            "resurrection": {"a": a_persist["resurrections"], "b": b_persist["resurrections"]},
            "wal": {"a": {"records": a_persist["wal"]["record_counts"],
                          "replayed": a_persist["wal"]["replay_counts"]},
                    "b": {"records": b_persist["wal"]["record_counts"],
                          "replayed": b_persist["wal"]["replay_counts"]}},
            "gateways": {"a": {"ledger": dict(plane.ledger), "spatial": type(ctl).__name__},
                         "b": {k: v for k, v in b_report.items()
                               if k not in ("placement", "events")}},
            "boot": boots,
            "census": {"expected": len(expected_ids), "on_a": len(a_placement),
                       "on_b": len(b_placement), "missing": missing,
                       "duplicated": {str(k): v for k, v in duplicated.items()},
                       "unexpected": unexpected},
            "invariants": inv.summary(),
        }
        if notes:
            report["notes"] = notes
        return report
    finally:
        stop.set()
        if snap_task is not None:
            snap_task.cancel()
        stop_processes(procs)
        if gw is not None:
            fed_teardown_gateway(P, gw)
        gs.global_death_miss_epochs = p.death_miss_epochs


def crash_soak_checks(r: dict) -> list:
    """16b's checks of one report, as (name, held, detail): every invariant
    of scripts/crash_soak.py under its own name, then the crashes in the
    script's order (one reclaimed, then one adopted), the child a gateway
    of the port on the host grid with no module of torch, of JAX or of the JAX
    package."""
    out = [(c["name"], c["ok"], c.get("detail", "")) for c in r["invariants"]["checks"]]
    b = r["gateways"]["b"]
    return out + [
        ("one_reclaimed_then_one_adopted",
         [c["phase"] for c in r["crashes"]] == ["reclaim", "adopt"],
         [c["phase"] for c in r["crashes"]]),
        ("child_imports_no_jax", b.get("modules") == [], b.get("modules")),
        ("child_on_the_host_grid", b.get("spatial") == "StaticGrid2DSpatialController",
         b.get("spatial"))]


def phase_crash_live(p: CrashSoakParams) -> dict:
    """16b: ``run_crash_soak`` through the port with a ``--crash-child``
    gateway SIGKILLed and restarted twice, held to every invariant of the
    script."""
    import asyncio
    import shutil
    import tempfile

    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix="crash-live-")
    t_phase = time.perf_counter()
    try:
        r = asyncio.run(run_crash_soak(P, p, scratch))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name, ok, detail in crash_soak_checks(r):
        check(ok, f"16b: {name}: {str(detail)[:300]}")
    print(f"16b crash soak live: scripts/crash_soak.py's run_crash_soak through the port, "
          f"gateway a in-process and gateway b a `chip_smoke.py --crash-child` process (no "
          f"module of torch, of JAX or of the JAX package loaded), both on WORLD_SPATIAL's "
          f"Static2DSpatialController with the WAL and the snapshot armed; {r['entities']} "
          f"entities, kill burst {p.kill_burst}; crashes {r['crashes']}; every invariant of the "
          f"script held ({len(r['invariants']['checks'])}); resurrections {r['resurrection']}; "
          f"WAL b {r['wal']['b']}; census {r['census']['on_a']} on a + {r['census']['on_b']} on "
          f"b of {r['census']['expected']}, none missing, duplicated or unexpected; timeline "
          f"{[(m['phase'], m['t']) for m in r['timeline']]}; child boots (b0 the first, b1 "
          f"and b2 the restarts) {boot_line(r['boot'])}; soak {r['duration_s']} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return r


# ---- the CPU legs of the costliest lockstep phases, in a child process -------


def cpu_leg_size(phase: str, scratch: str, **kw) -> dict:
    """The size of a lockstep phase whose CPU leg runs in a child: ``6a``,
    ``10a``, ``11a``, ``11b`` (its mesh config written into ``scratch``),
    ``12b``, ``14a`` and ``19a`` (their cells configs written into
    ``scratch``) and ``16a``, each from its size function with ``kw``."""
    if phase == "6a":
        return gateway_size(**kw)
    if phase == "10a":
        return recovery_size(**kw)
    if phase == "14a":
        return overload_lockstep_size(scratch, **kw)
    if phase == "11a":
        return elastic_size(**kw)
    if phase == "11b":
        return elastic_mesh_size(scratch, **kw)
    if phase == "12b":
        return sensor_soak_scenario(**kw)
    if phase == "16a":
        return crash_size(**kw)
    if phase == "19a":
        return loss_lockstep_size(scratch, **kw)
    raise ValueError(f"no CPU leg for phase {phase!r}")


def cpu_leg_child(phase: str, scratch: str) -> int:
    """``chip_smoke.py --cpu-leg PHASE SCRATCH``: run ``phase``'s CPU leg at
    the size pickled in SCRATCH/size.pickle and pickle (observations,
    report) into SCRATCH/leg.pickle for the parent to compare."""
    import os
    import pickle

    from channeld_tpu_torch.ops import cuda_kernels as K

    os.nice(10)  # the card leg beside it keeps the host first
    with open(os.path.join(scratch, "size.pickle"), "rb") as f:
        size = pickle.load(f)
    cpu = torch.device("cpu")
    if phase == "6a":
        result = run_gateway_leg(K, cpu, size)
    elif phase == "10a":
        result = run_recovery_leg(K, cpu, size, os.path.join(scratch, "cpu.snap"))
    elif phase == "14a":
        result = run_overload_lockstep(gateway_modules(), cpu, size["params"], size["config"])
    elif phase in ("11a", "11b"):
        result = run_elastic_leg(K, "cpu", cpu, size, phase)
    elif phase == "12b":
        P = gateway_modules()
        result = run_soak_leg(K, "cpu", cpu,
                              lambda leg, d, clock: SensorSoakWorld(P, d, clock, size),
                              sensor_soak_run(K, size, {}))
    elif phase == "16a":
        result = run_crash_leg(gateway_modules(), cpu, size, scratch)
    elif phase == "19a":
        result = run_loss_lockstep(gateway_modules(), cpu, size)
    else:
        raise ValueError(f"no CPU leg for phase {phase!r}")
    out = os.path.join(scratch, "leg.pickle")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(out + ".tmp", out)
    return 0


class PhaseLaps:
    """The full run's wall time per phase group, printed as each ends."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: list = []

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.laps.append((label, now - self.t))
        print(f"phase {label} wall time: {now - self.t:.1f} s")
        self.t = now

    def summary(self) -> str:
        return ", ".join(f"{label} {secs:.1f} s" for label, secs in self.laps)


class CpuLeg:
    """A lockstep phase's CPU leg running in a ``--cpu-leg`` child while this
    process runs the card leg (the full script starts it a phase or two
    earlier, beside phases whose host is mostly idle). ``size`` is the
    phase's size (``cpu_leg_size(phase, scratch, **kw)``): the child runs
    at it and the phase runs its card leg at it."""

    def __init__(self, phase: str, **kw):
        import os
        import pickle
        import tempfile

        self.phase = phase
        self.scratch = tempfile.mkdtemp(prefix=f"cpu-leg-{phase}-")
        self.size = cpu_leg_size(phase, self.scratch, **kw)
        with open(os.path.join(self.scratch, "size.pickle"), "wb") as f:
            pickle.dump(self.size, f, protocol=pickle.HIGHEST_PROTOCOL)
        self.out = os.path.join(self.scratch, "leg.pickle")
        self.log = os.path.join(self.scratch, "leg.log")
        self.t0 = time.perf_counter()
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cpu-leg", phase, self.scratch],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=log)

    def result(self) -> tuple:
        """Wait for the child; (observations, report), the report's ``secs``
        the child's own."""
        import pickle
        import shutil

        try:
            rc = self.proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            rc = "killed after 900 s"
        try:
            if rc != 0:
                with open(self.log) as f:
                    tail = f.read()[-1500:]
                raise PhaseFailed(f"{self.phase}: the --cpu-leg child exited {rc}: {tail}")
            with open(self.out, "rb") as f:
                obs, report = pickle.load(f)
        finally:
            self.close()
        report["wall_s"] = time.perf_counter() - self.t0
        return obs, report

    def close(self) -> None:
        """Stop the child if the phase ended without its result."""
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.scratch, ignore_errors=True)


def phase_crash_lockstep(K, dev, cpu_leg: CpuLeg) -> tuple:
    """16a: ``CrashWorld`` on the card against its lockstep CPU leg in
    ``cpu_leg``'s child, at ``cpu_leg.size``, tick for tick through both
    crashes, both held to the crash soak's books. Returns (K1/K2 launches,
    the kernels' entries on each restart's first tick and the yield
    tick)."""
    import shutil
    import tempfile

    P = gateway_modules()
    size = cpu_leg.size
    scratch = tempfile.mkdtemp(prefix="crash-lockstep-")
    t_phase = time.perf_counter()
    try:
        card, rc = run_crash_leg(P, dev, size, scratch, K)
        cpu, rp = cpu_leg.result()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
        cpu_leg.close()
    check(len(card) == len(cpu), f"16a: {len(card)} card and {len(cpu)} cpu ticks")
    for t in range(len(card)):
        if card[t].get("down") or cpu[t].get("down"):
            check(card[t] == cpu[t], f"16a tick {t}: b down on one leg only")
            continue
        where = first_gateway_diff(card[t], cpu[t])
        for key in ("agent_rows", "wal", "snapshot"):
            if where is None and card[t][key] != cpu[t][key]:
                where = f"{key}: {card[t][key]} vs {cpu[t][key]}"
        check(where is None, f"16a tick {t}: cuda and cpu differ: {where}")
    for key in ("replays", "kills", "booted", "lost", "duplicated", "ledger", "control",
                "resurrections", "stub", "stub_log", "sim", "journal", "yield_at", "census"):
        check(rc[key] == rp[key], f"16a: cuda and cpu differ in {key}: {str(rc[key])[:200]} vs "
                                  f"{str(rp[key])[:200]}")
    for leg, obs, r in (("cuda", card, rc), ("cpu", cpu, rp)):
        for name, ok, detail in crash_checks(obs, r):
            check(ok, f"16a {leg}: {name}: {str(detail)[:300]}")
    up = [(t, o) for t, o in enumerate(card) if not o.get("down")]
    for t, o in up:
        want = {name: o["ran"] for name in o["launches"]}
        check(o["launches"] == want, f"16a tick {t}: launches {o['launches']} in {o['ran']} "
                                     f"engine ticks (one of each per engine tick)")
    steady = sorted({o["reads"] for t, o in up if o["served"] and not o["census"]
                     and t not in (CRASH_AT["restart1"], CRASH_AT["restart2"])})
    check(set(rc["kernels"]) == {"restart1", "restart2", "yield"},
          f"16a: K1/K2 held on the live tensors of {sorted(rc['kernels'])} only")
    trunk_out = sum(len(o["trunk"]["a"]) for t, o in up)
    p = CrashSoakParams()
    print(f"16a crash lockstep: gateway b of scripts/crash_soak.py's WORLD_SPATIAL (4x4 cells of "
          f"50 m, b hosts {len(CRASH_CELLS['b'])} cells) on the device controller at "
          f"{size['entity_capacity']} slots / {size['query_capacity']} query rows, "
          f"{len(card)} GLOBAL ticks of a fixed {CRASH_TICK_S * 1e3:g} ms clock ({len(up)} up, "
          f"killed at ticks {CRASH_AT['kill1']} and {CRASH_AT['kill2']}, restarted at "
          f"{CRASH_AT['restart1']} and {CRASH_AT['restart2']}), {size['entities']} entities a "
          f"side, {size['agents']} sim agents (census every {CRASH_CENSUS_EVERY} passes), "
          f"{size['sensors']} sensors, the WAL (fsync {p.fsync_ms:g} ms, flushed at the end of "
          f"every tick b serves) and the snapshot (every {p.snapshot_interval_s:g} s) armed; "
          f"stub a the leader: commits {size['commits']} each way, kill bursts of "
          f"{size['burst']}, death after {p.death_miss_epochs} missed {p.epoch_ms} ms epochs; "
          f"every check held on both legs: "
          + ", ".join(name for name, _, _ in crash_checks(card, rc))
          + f"; replays {[{k: r[k] for k in ('snapshot_channels', 'wal_records', 'torn', 'in_flight_resolved')} for r in rc['replays']]}; "
          f"WAL at the kills {rc['kills']}; resurrections b {rc['resurrections']}, stub "
          f"{rc['stub']}; federation ledger {rc['ledger']}, control counters {rc['control']}; "
          f"{trunk_out} trunk messages from b; cuda equals the CPU leg on every tick (handovers, "
          f"trunk messages as bytes in order, tables, placement ledger, engine slots, cells and "
          f"counts, agents and sim columns, changed query rows, every ledger, the WAL's bytes, "
          f"the snapshot, the stub's holdings, every outbound stream, each restart's agents "
          f"and device baselines before its first tick); device reads a steady "
          f"tick {steady}; launches {rc['launches']} in {rc['engine_ticks']} engine ticks; "
          f"card memory {[(m, f'{b / 2**20:.1f} MiB') for m, b in rc['memory']]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s (card leg {rc['secs']:.1f} s, cpu leg "
          f"{rp['secs']:.1f} s in a --cpu-leg child)")
    for leg, obs, r in (("cuda", card, rc), ("cpu", cpu, rp)):
        ups = [o for o in obs if not o.get("down")]
        steps = [o["step_ms"] for o in ups[1:] if o["step_ms"] is not None]
        print(f"16a on {leg}: tick (host clock) {tick_stats([o['tick_ms'] for o in ups[1:]])}; "
              f"guarded step {tick_stats(steps)}; restart to serving (boot, replay and first "
              f"tick, host clock) " + ", ".join(f"{s * 1e3:.1f}" for s in r["restart_s"])
              + " ms; boot_replay " + ", ".join(f"{s * 1e3:.2f}" for s in r["replay_s"]) + " ms")
    entries: dict = {}
    for case, ks in sorted(rc["kernels"].items()):
        for name, k in ks.items():
            entries.setdefault(name, {})[f"16a_{case}"] = k
            print(f"16a {name} on the live tensors at the {case} tick ({k['shape']}): exact; "
                  f"alone {k['ms']:.4f} ms (events, bare launches), plain {k['plain_ms']:.4f} "
                  f"ms, bound {k['bound_ms']:.6f} ms ({k['bound_by']})")
    return rc["launches"], entries


def phase_crash(K, dev, cpu_leg: CpuLeg) -> tuple:
    """16a (its CPU leg in ``cpu_leg``'s child) and 16b. Returns ({path:
    launches}, {kernel: {case: entry}})."""
    t_phase = time.perf_counter()
    launches, entries = phase_crash_lockstep(K, dev, cpu_leg)
    phase_crash_live(CrashSoakParams())
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return {"crash_lockstep": launches}, entries


# ---- phase 17: the last live fleet paths through the port --------------------
# Phase 2 of scripts/trace_soak.py and of scripts/obs_soak.py, and
# scripts/global_soak.py's three gateways. Every gateway boots through
# scripts/federation_soak.py's boot_gateway, whose world is a
# Static2DSpatialController: the host grid, which touches no device by the
# scripts' own design, so no kernel runs on these paths. Gateway "a" runs in
# this process on its asyncio loop; the others are ``--live-child`` processes
# of this script (they load neither torch, JAX nor the JAX package).

LIVE_CHILD_ROLES = ("trace", "obs", "global")
FLEET_LIVE_NOTE = ("phase 17: every gateway on the script's Static2DSpatialController (the host "
                   "grid), which runs no kernel by the script's design")
# The invariants of each path, under the scripts' names (TRACE_r11.json's and
# OBS_r15.json's federation checks; all of SOAK_GLOBAL_r12.json's).
TRACE_FED_INVARIANTS = ("cross_gateway_trace_stitched", "cross_gateway_committed",
                        "trunk_stage_measured", "handover_abort_anomaly_dumped")
OBS_FED_INVARIANTS = ("fleet_digest_exact", "fleet_labelsets_checked", "fleet_json_and_leader")
GLOBAL_INVARIANTS = (
    "shard_migrations_committed", "imbalance_flattened_below_enter", "c_declared_dead",
    "shard_adopted", "every_entity_on_exactly_one_survivor",
    "a_migrations_ledger_matches_metric", "b_migrations_ledger_matches_metric",
    "a_adoptions_ledger_matches_metric", "b_adoptions_ledger_matches_metric",
    "a_deaths_ledger_matches_metric", "b_deaths_ledger_matches_metric",
    "client_redirect_received", "redirect_resumed_on_adopter_without_reauth",
    "nothing_left_in_flight")
GLOBAL_ESTART = 0x00080000  # scripts/global_soak.py's first entity channel id
HOST_GRID = "StaticGrid2DSpatialController"


def trace_fed_params(**kw) -> dict:
    """scripts/trace_soak.py's TraceSoakParams for its phase 2."""
    return dict(dict(fed_burst=10, fed_sever_burst=10, seed=TRACE_SOAK_SEED), **kw)


def obs_fed_params(**kw) -> dict:
    """scripts/obs_soak.py's ObsSoakParams for its phase 2."""
    return dict(dict(fed_run_s=8.0, fed_epoch_ms=200, seed=OBS_SOAK_SEED), **kw)




# scripts/obs_soak.py's sample line of the Prometheus exposition.
_EXPO_RE = re.compile(r"^([a-zA-Z_][a-zA-Z0-9_]*)(\{[^}]*\})?\s+([0-9.eE+-]+|NaN|[+-]Inf)$")


def parse_exposition(text: str) -> dict:
    """scripts/obs_soak.py's ``parse_exposition``: {(name, labels): value}
    of every sample line."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        m = _EXPO_RE.match(line.strip())
        if m:
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def fleet_exactness(merge, b_self: dict, b_stored: dict, a_digest: dict, rendered: dict) -> tuple:
    """scripts/obs_soak.py's two exactness legs: b's own digest equals the
    copy stored on a, and every counter family and label set of a's
    rendered /fleet (``rendered``, parsed) equals the sum of a's and b's
    digests (``merge``: federation/obs.py's ``merge_digests``). Returns
    (mismatches, label sets checked)."""
    mismatches = []
    for section in ("counters", "gauges"):
        for family, rows in b_self[section].items():
            stored_rows = b_stored.get(section, {}).get(family, {})
            for key, v in rows.items():
                if abs(stored_rows.get(key, 0.0) - v) > 1e-9:
                    mismatches.append(f"{section}:{family}{key} self={v} "
                                      f"stored={stored_rows.get(key)}")
    merged = merge([a_digest, b_stored])
    checked = 0
    for family, rows in merged["counters"].items():
        for key, v in rows.items():
            pairs = json.loads(key)
            labels = ("{" + ",".join(f'{k}="{val}"' for k, val in pairs) + "}") if pairs else ""
            got = rendered.get((f"fleet_{family}_total", labels))
            checked += 1
            if got is None or abs(got - v) > 1e-9:
                mismatches.append(f"/fleet fleet_{family}_total{labels} got={got} want={v}")
    return mismatches, checked


class ChildNotReady(PhaseFailed):
    """A phase-17 child that never printed READY: the one fault a retry may
    cover (as tests/test_global_control.py retries an infra failure once)."""


def spawn_live_child(role: str, gw_id: str, cfg_path: str, report_path: str, params: dict,
                     scratch: str) -> FedChild:
    """Start ``chip_smoke.py --live-child ROLE GW CONFIG REPORT PARAMS`` (its
    standard error into ``scratch``); the handle keeps the time just before
    the start (``t0``) and the log's path."""
    import os

    log_path = os.path.join(scratch, f"live_child_{role}_{gw_id}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--live-child", role, gw_id, cfg_path,
             report_path, json.dumps(params)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=log, text=True)
    return FedChild(proc, t0, log_path)


async def wait_ready(children: dict, timeout: float) -> dict:
    """Wait for every child's READY line together: {gateway: its boot report
    (READY's JSON) with ``boot_s``, Popen to READY}."""
    import asyncio

    async def one(gw: str, child) -> tuple:
        try:
            line = await child.wait_for("READY", timeout)
        except (RuntimeError, TimeoutError) as e:
            with open(child.log) as f:
                tail = f.read()[-600:]
            raise ChildNotReady(f"gateway {gw}: the --live-child never printed READY ({e}): "
                                f"{tail}")
        return gw, child_boot(child, line)

    return dict(await asyncio.gather(*(one(gw, c) for gw, c in children.items())))


def stop_processes(procs) -> None:
    """scripts/*_soak.py's teardown of their child gateways: ``exit`` on
    stdin, then a kill after 8 s."""
    for proc in procs:
        if proc.poll() is None:
            with contextlib.suppress(BrokenPipeError, OSError):
                proc.stdin.write('{"cmd": "exit"}\n')
                proc.stdin.flush()
            try:
                proc.wait(timeout=8)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()




async def trace_fed_live(P, p: dict, scratch: str) -> dict:
    """17a: scripts/trace_soak.py's ``run_federation_phase`` through the
    port. Gateway "a" in-process (the recorder armed with origin "a", its
    dumps into ``scratch``) and gateway "b" a ``--live-child trace``
    process: a committed burst across the trunk, the trunk severed while a
    handover is pending, the drain, b's spans; the result under the
    script's keys, with the child's boot, its modules and both
    controllers."""
    import asyncio
    import os

    from random import Random

    t_start = time.monotonic()
    ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client"), fed_free_ports(4)))
    fed_cfg = fed_config(ports)
    cfg_path = os.path.join(scratch, "trace_fed_cfg.json")
    report_path = os.path.join(scratch, "trace_fed_b.json")
    dump_dir = os.path.join(scratch, "dumps")
    os.makedirs(dump_dir, exist_ok=True)
    with open(cfg_path, "w") as f:
        json.dump(fed_cfg, f)
    child = spawn_live_child("trace", "b", cfg_path, report_path, p, scratch)
    stop = asyncio.Event()
    gw = None
    try:
        boot = await wait_ready({"b": child}, 60.0)
        gw = await fed_boot_gateway(P, "a", fed_cfg, FedSoakParams(**PHASE2_TRUNK), stop, scratch)
        plane, ctl = gw["plane"], gw["ctl"]
        P.settings.global_settings.trace_enabled = True
        recorder = P.tracing.recorder
        recorder.configure(enabled=True, ring_spans=16384, dump_path=dump_dir,
                           anomaly_cooldown_s=0.5, origin="a")
        # This process ran other trunks before: the trunk stage of this
        # phase is the delta since a's boot (in the script, a plain scrape).
        baseline = P.invariants.scrape()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and plane.link_to("b") is None:
            await asyncio.sleep(0.05)
        if plane.link_to("b") is None:
            raise PhaseFailed("17a: trunk to b never came up")

        sim = FedSim(P, ctl, Random(p["seed"] ^ 0xF2))
        sim.create_entities(p["fed_burst"] + p["fed_sever_burst"] + 4, -98.0, -2.0, -98.0, 98.0)
        await asyncio.sleep(0.5)

        # -- committed burst: one trace id per batch crosses the trunk --
        sim.herd(sim.entity_ids[: p["fed_burst"]], 2.0, 98.0, -98.0, 98.0)
        cdeadline = time.monotonic() + 20.0
        while time.monotonic() < cdeadline and plane.ledger.get("committed", 0) < p["fed_burst"]:
            await asyncio.sleep(0.05)
        committed = plane.ledger.get("committed", 0)

        # -- sever mid-burst: the handover_abort anomaly dump --
        sim.herd(sim.local_ids()[: p["fed_sever_burst"]], 2.0, 98.0, -98.0, 98.0)
        sdeadline = time.monotonic() + 5.0
        severed = False
        while time.monotonic() < sdeadline:
            link = plane.link_to("b")
            if plane._pending and link is not None:
                link.sever_for_test()
                severed = True
                break
            await asyncio.sleep(0.001)
        ddeadline = time.monotonic() + 30.0
        while time.monotonic() < ddeadline and (plane._pending or plane._parked):
            await asyncio.sleep(0.1)
        await asyncio.sleep(1.0)

        await child.cmd("report", timeout=15.0)
        with open(report_path) as f:
            b_report = json.load(f)
        a_spans = [{"name": s["name"], "trace": s["trace"], "tick": s["tick"]}
                   for s in recorder.snapshot() if s.get("trace")]
        b_spans = b_report["spans"]
        a_traces = {s["trace"] for s in a_spans if s["name"] in ("fed.prepare", "fed.commit")}
        b_traces = {s["trace"] for s in b_spans if s["name"] in ("fed.apply", "fed.refuse")}
        stitched = sorted(a_traces & b_traces)
        example = None
        if stitched:
            tid = stitched[0]
            example = {"trace_id": tid,
                       "a_spans": sorted(s["name"] for s in a_spans if s["trace"] == tid),
                       "b_spans": sorted(s["name"] for s in b_spans if s["trace"] == tid)}
        abort_dumps = [{"trigger": a["trigger"], "detail": a["detail"],
                        "path": os.path.basename(a["path"]),
                        "perfetto_valid": check_perfetto(a["path"])[0]}
                       for a in recorder.anomalies
                       if a["trigger"] == "handover_abort" and "path" in a]
        inv = P.invariants
        trunk_stats = stage_stats(P, inv.delta(inv.scrape(), baseline)).get("trunk", {})
        return {"trunk_stage": trunk_stats, "committed": committed, "severed": severed,
                "aborted": plane.ledger.get("aborted", 0), "stitched_traces": len(stitched),
                "example": example, "abort_dumps": abort_dumps,
                "trunk_stage_samples": int(trunk_stats.get("count", 0)),
                "b_ledger": b_report["ledger"], "boot": boot,
                "b_modules": b_report["modules"], "spatial": [type(ctl).__name__,
                                                              b_report["spatial"]],
                "duration_s": round(time.monotonic() - t_start, 2)}
    finally:
        stop.set()
        stop_processes([child.proc])
        if gw is not None:
            fed_teardown_gateway(P, gw)


def trace_fed_checks(r: dict, live: dict) -> list:
    """17a's checks of one result, as (name, held, detail): the trace soak's
    phase-2 invariants under their names; ``every_tick_stage_measured`` over
    13b's stages (``live``: its stages and whether the native codec ran the
    batched ingest) with the trunk stage, ``ingest`` expected only with the
    native codec (F19); the child a gateway of the port with no module of
    JAX or of the JAX package; both gateways on the host grid."""
    stages = dict(live["stages"])
    if r["trunk_stage"]:
        stages["trunk"] = r["trunk_stage"]
    expected = [s for s in TRACE_STAGES if s != "ingest" or live["batched_ingest"]] + ["trunk"]
    modules = (r["boot"]["b"].get("modules"), r["b_modules"])
    return [
        ("every_tick_stage_measured", all(s in stages for s in expected),
         f"stages seen: {sorted(stages)}, expected {expected}"),
        ("cross_gateway_trace_stitched", r["stitched_traces"] > 0, r["stitched_traces"]),
        ("cross_gateway_committed", r["committed"] > 0, r["committed"]),
        ("trunk_stage_measured", r["trunk_stage_samples"] > 0, r["trunk_stage_samples"]),
        ("handover_abort_anomaly_dumped",
         bool(r["abort_dumps"]) and all(d["perfetto_valid"] for d in r["abort_dumps"]),
         r["abort_dumps"]),
        ("child_imports_no_jax", modules == ([], []), modules),
        ("both_gateways_on_the_host_grid", r["spatial"] == [HOST_GRID] * 2, r["spatial"])]


async def obs_fed_live(P, p: dict, scratch: str) -> dict:
    """17b: scripts/obs_soak.py's ``run_federation_phase`` through the port.
    Gateway "a" in-process (the SLO plane and the control plane on, epoch
    ``fed_epoch_ms``, the ops surface on an ephemeral port of loopback) and
    gateway "b" a ``--live-child obs`` process: 8 entities, 4 herded across,
    ``fed_run_s`` of traffic, the quiesce and two more epochs, then both
    exactness legs over b's own digest, the copy stored on a and a's
    rendered /fleet; the result under the script's keys, with the child's
    boot, its modules and both controllers."""
    import asyncio
    import os

    from random import Random

    t_start = time.monotonic()
    P.fleet_obs.reset_fleet_obs()  # no digest an earlier fleet of this process stored
    fleet = P.fleet_obs.fleet
    ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client"), fed_free_ports(4)))
    fed_cfg = fed_config(ports)
    cfg_path = os.path.join(scratch, "obs_fed_cfg.json")
    report_path = os.path.join(scratch, "obs_fed_b.json")
    with open(cfg_path, "w") as f:
        json.dump(fed_cfg, f)
    child = spawn_live_child("obs", "b", cfg_path, report_path, p, scratch)
    stop = asyncio.Event()
    gw = None
    try:
        boot = await wait_ready({"b": child}, 60.0)
        gw = await fed_boot_gateway(P, "a", fed_cfg, FedSoakParams(**PHASE2_TRUNK), stop, scratch,
                                    settings_hook=obs_fed_settings_hook(p["fed_epoch_ms"]))
        plane = gw["plane"]
        P.slo.slo.configure(enabled=True)
        ops = P.opshttp.serve_ops(0, host="127.0.0.1")
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and plane.link_to("b") is None:
            await asyncio.sleep(0.05)
        if plane.link_to("b") is None:
            raise PhaseFailed("17b: trunk to b never came up")

        # Cross-gateway traffic so the digests carry real numbers.
        sim = FedSim(P, gw["ctl"], Random(p["seed"] ^ 0xFED))
        sim.create_entities(8, -98.0, -2.0, -98.0, 98.0)
        await asyncio.sleep(0.5)
        sim.herd(sim.entity_ids[:4], 2.0, 98.0, -98.0, 98.0)
        t0 = time.monotonic()
        while time.monotonic() - t0 < p["fed_run_s"]:
            await asyncio.sleep(0.2)
        # Quiesce: the digest families go static, then two more epochs so
        # that b's last export reflects the static state.
        await asyncio.sleep(max(4 * p["fed_epoch_ms"] / 1000.0, 1.0))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and "b" not in fleet.digests:
            await asyncio.sleep(0.1)
        if "b" not in fleet.digests:
            raise PhaseFailed("17b: b's metric digest never arrived")

        await child.cmd("report", timeout=15.0)
        with open(report_path) as f:
            b_report = json.load(f)
        b_stored = fleet.digests["b"][0]
        code, text = ops_get(ops.port, "/fleet", timeout=5.0)
        mismatches, checked = fleet_exactness(
            P.fleet_obs.merge_digests, b_report["digest"], b_stored, fleet.refresh_local(),
            parse_exposition(text) if code == 200 else {})
        code_json, fleet_json = ops_get(ops.port, "/fleet?format=json")
        return {
            "digest_exact": not mismatches, "mismatches": mismatches[:20],
            "labelsets_checked": checked, "gateways_in_fleet": sorted(fleet.digests),
            "fleet_json_ok": (code_json == 200
                              and fleet_json.get("gateways", {}).get("b", {}).get("up") is True),
            "leader": fleet_json.get("leader", "") if code_json == 200 else "",
            "committed_handovers": plane.ledger.get("committed", 0),
            "trunk_rtt_slo_tracked": "trunk_rtt" in P.slo.slo.status(),
            "boot": boot, "b_modules": b_report["modules"],
            "spatial": [type(gw["ctl"]).__name__, b_report["spatial"]],
            "duration_s": round(time.monotonic() - t_start, 2)}
    finally:
        stop.set()
        stop_processes([child.proc])
        P.opshttp.reset_ops()
        P.slo.reset_slo()
        P.fleet_obs.reset_fleet_obs()
        if gw is not None:
            fed_teardown_gateway(P, gw)


def obs_fed_checks(r: dict) -> list:
    """17b's checks of one result, as (name, held, detail): the obs soak's
    phase-2 invariants under their names, the child a gateway of the port
    with no module of torch, of JAX or of the JAX package, both gateways on the host
    grid."""
    modules = (r["boot"]["b"].get("modules"), r["b_modules"])
    return [
        ("fleet_digest_exact", r["digest_exact"], r["mismatches"]),
        ("fleet_labelsets_checked", r["labelsets_checked"] > 20, r["labelsets_checked"]),
        ("fleet_json_and_leader", r["fleet_json_ok"] and r["leader"] != "",
         {k: r[k] for k in ("fleet_json_ok", "leader", "gateways_in_fleet")}),
        ("child_imports_no_jax", modules == ([], []), modules),
        ("both_gateways_on_the_host_grid", r["spatial"] == [HOST_GRID] * 2, r["spatial"])]


async def run_global_soak(P, p: GlobalSoakParams, scratch: str) -> dict:
    """17c: scripts/global_soak.py's ``run_global_soak`` through the port.
    Gateway "a" (the leader) in-process on this asyncio loop, gateways "b"
    and "c" ``--live-child global`` processes, all on WORLD_3's
    Static2DSpatialController: the hotspot on b flattened by a
    leader-planned migration, c SIGKILLed while the a->c burst is in flight,
    c declared dead and its shard adopted, the redirected client resumed on
    a survivor, the census over the survivors. The report under the
    script's keys (the 14 invariants under their names), with both
    children's boots."""
    import asyncio
    import dataclasses as dc
    import os
    import signal

    from random import Random

    control, journal = P.federation.control, P.failover.journal
    t_start = time.monotonic()
    ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client", "c_trunk", "c_client"),
                     fed_free_ports(6)))
    fed_cfg = fed_config3(ports)
    cfg_path = os.path.join(scratch, "global_soak_cfg.json")
    b_report_path = os.path.join(scratch, "global_soak_b.json")
    c_report_path = os.path.join(scratch, "global_soak_c.json")
    with open(cfg_path, "w") as f:
        json.dump(fed_cfg, f)
    params = dc.asdict(p)
    b = spawn_live_child("global", "b", cfg_path, b_report_path, params, scratch)
    c = spawn_live_child("global", "c", cfg_path, c_report_path, params, scratch)
    stop = asyncio.Event()
    gw = client_task = None
    timeline: list = []
    notes: list = []

    def mark(phase: str, **kw) -> None:
        timeline.append({"t": round(time.monotonic() - t_start, 2), "phase": phase, **kw})

    try:
        boot = await wait_ready({"b": b, "c": c}, p.child_boot_timeout_s)
        gw = await global_boot(P, "a", fed_cfg, p, stop, scratch)
        plane, ctl = gw["plane"], gw["ctl"]
        baseline = P.invariants.scrape()

        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and (plane.link_to("b") is None
                                               or plane.link_to("c") is None):
            await asyncio.sleep(0.05)
        if plane.link_to("b") is None or plane.link_to("c") is None:
            raise PhaseFailed("17c: the trunk mesh never came up")
        mark("trunk_mesh_up", leader=control.leader())

        sim = FedSim(P, ctl, Random(p.seed ^ 0xA))
        sim.create_entities(p.base_entities, *GLOBAL_XR["a"], *GLOBAL_ZR, base=GLOBAL_BASE["a"])
        await b.cmd("spawn", n=p.base_entities)
        await c.cmd("spawn", n=p.base_entities)
        estart = GLOBAL_ESTART
        expected_ids = {str(estart + 1 + GLOBAL_BASE[g] + i)
                        for g in ("a", "b", "c") for i in range(p.base_entities)}
        # A few control epochs to see everyone's vectors and replicas.
        await asyncio.sleep(p.epoch_ms * 4 / 1000.0)
        mark("boot", entities=len(expected_ids))

        # ---- phase 1: hotspot on b -> the leader flattens it ----
        await b.cmd("spawn", n=p.hotspot, offset=100)
        expected_ids |= {str(estart + 1 + GLOBAL_BASE["b"] + 100 + i) for i in range(p.hotspot)}
        end = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < end and control.ledger.get("committed", 0) < 1:
            await asyncio.sleep(0.1)
        if control.ledger.get("committed", 0) < 1:
            notes.append(f"no committed shard migration: ledger={control.ledger} "
                         f"imbalance={control.imbalance}")
        fdeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < fdeadline and (control.imbalance >= p.imbalance_enter
                                                or control._plans or control._drain is not None):
            await asyncio.sleep(0.2)
        committed_migrations = control.ledger.get("committed", 0)
        flattened_imbalance = control.imbalance
        mark("hotspot_flattened", committed=committed_migrations,
             imbalance=round(flattened_imbalance, 3), ledger=dict(control.ledger))

        # ---- phase 2: commit a->c handovers, anchor a client on one of them ----
        local_a = [e for e in sim.local_ids() if e < estart + 1 + GLOBAL_BASE["b"]]
        committed_before = plane.ledger.get("committed", 0)
        herd_ids = local_a[: p.committed_to_c]
        anchor_eid = herd_ids[0]
        redirect_result: dict = {}
        client_task = asyncio.ensure_future(wait_redirect(
            P, "127.0.0.1", gw["client_port"], "global-client-0", redirect_result, stop))
        cdeadline = time.monotonic() + 10.0
        anchor_conn = None
        while time.monotonic() < cdeadline and anchor_conn is None:
            for conn in P.connection.all_connections().values():
                if getattr(conn, "pit", "") == "global-client-0" and not conn.is_closing():
                    anchor_conn = conn
                    break
            await asyncio.sleep(0.05)
        if anchor_conn is None:
            raise PhaseFailed("17c: the anchored client never authed")
        plane.set_client_anchor(anchor_conn, anchor_eid)
        sim.herd(herd_ids, *GLOBAL_XR["c"], *GLOBAL_ZR)
        hdeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < hdeadline and (
                plane.ledger.get("committed", 0) < committed_before + len(herd_ids)):
            await asyncio.sleep(0.1)
        rdeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < rdeadline and "redirect" not in redirect_result:
            await asyncio.sleep(0.1)
        if "redirect" not in redirect_result:
            notes.append(f"redirect never arrived: {redirect_result}")
        # At least one control epoch, so that c's replica (the staged handle
        # and the committed entities too) reaches the survivors.
        await asyncio.sleep(p.epoch_ms * 3 / 1000.0)
        mark("committed_into_c", committed=plane.ledger.get("committed", 0) - committed_before,
             redirect=redirect_result.get("redirect"))

        # ---- phase 3: SIGKILL c mid-handover-burst ----
        sim.adopt_scan()
        local_a = [e for e in sim.local_ids() if entity_alive(P, e)]
        sim.herd(local_a[: p.kill_burst], *GLOBAL_XR["c"], *GLOBAL_ZR)
        kdeadline = time.monotonic() + 5.0
        killed_mid_burst = False
        while time.monotonic() < kdeadline:
            if any(bt.peer == "c" for bt in plane._pending.values()):
                c.proc.send_signal(signal.SIGKILL)
                killed_mid_burst = True
                break
            await asyncio.sleep(0)
        if not killed_mid_burst:
            c.proc.send_signal(signal.SIGKILL)
            notes.append("kill raced: no batch toward c in flight at kill")
        t_kill = time.monotonic()
        mark("sigkill_c", mid_burst=killed_mid_burst)

        # Death declaration and adoption.
        adeadline = time.monotonic() + p.phase_timeout_s * 2
        while time.monotonic() < adeadline and "c" not in control.dead:
            await asyncio.sleep(0.1)
        if "c" not in control.dead:
            raise PhaseFailed(f"17c: c never declared dead: report={control.report()}")
        t_dead = time.monotonic()
        adopter = None
        adeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < adeadline and adopter is None:
            for ev in control.events:
                if ev.get("kind") == "gateway_dead" and ev["dead"] == "c":
                    adopter = ev["adopter"]
                    break
            await asyncio.sleep(0.1)
        if adopter is None:
            raise PhaseFailed("17c: no adoption assignment observed")
        if adopter == "a":
            wdeadline = time.monotonic() + p.phase_timeout_s
            while time.monotonic() < wdeadline and control.adoptions < 1:
                await asyncio.sleep(0.1)
        else:
            await asyncio.sleep(p.epoch_ms * 6 / 1000.0)
        mark("adopted", adopter=adopter, deaths=control.deaths)

        # ---- phase 4: the redirect client resumes on a survivor ----
        resume_result: dict = {}
        resume_s: dict = {}
        if redirect_result.get("redirect"):
            # The redirect's target (c) is dead: a well-behaved client falls
            # back to the surviving gateways in directory order.
            for target in ("a", "b"):
                port = int(fed_cfg["gateways"][target]["client"].rpartition(":")[2])
                t0 = time.monotonic()
                try:
                    await resume_on(P, "127.0.0.1", port, "global-client-0", resume_result)
                except (ConnectionError, OSError, TimeoutError) as e:
                    resume_result.setdefault("errors", []).append(f"{target}: {e}")
                    continue
                finally:
                    resume_s[target] = round(time.monotonic() - t0, 3)
                if resume_result.get("should_recover"):
                    resume_result["resumed_on"] = target
                    break
        mark("client_resumed", **{k: v for k, v in resume_result.items()
                                  if k != "recovery_channels"})

        # ---- quiesce and census across the survivors ----
        await b.cmd("quiesce", timeout=p.phase_timeout_s + 5.0, drain_s=p.phase_timeout_s)
        qdeadline = time.monotonic() + p.phase_timeout_s
        while time.monotonic() < qdeadline and (
                plane._pending or plane._parked or journal.in_flight_count()):
            await asyncio.sleep(0.1)
        await asyncio.sleep(p.quiesce_s)
        await b.cmd("report", timeout=15.0)
        with open(b_report_path) as f:
            b_report = json.load(f)
        a_placement = fed_local_placement(P)
        b_placement = dict(b_report["placement"])
        local_dups_a = a_placement.pop("__local_dups__", [])
        local_dups_b = b_placement.pop("__local_dups__", [])
        a_control = global_control_report(P, baseline)

        inv = P.invariants.InvariantChecker()
        inv.expect_gt("shard_migrations_committed", committed_migrations, 0)
        inv.check("imbalance_flattened_below_enter", flattened_imbalance < p.imbalance_enter,
                  f"imbalance={flattened_imbalance} enter={p.imbalance_enter}")
        inv.check("c_declared_dead", "c" in control.dead, "")
        inv.expect_gt("shard_adopted", a_control["adoptions"] + b_report["control"]["adoptions"],
                      0)
        counts: dict = {}
        for eid, cell in a_placement.items():
            counts.setdefault(eid, []).append(("a", cell))
        for eid, cell in b_placement.items():
            counts.setdefault(eid, []).append(("b", cell))
        missing = sorted(e for e in expected_ids if e not in counts)
        duplicated = {e: w for e, w in counts.items() if len(w) > 1}
        unexpected = sorted(e for e in counts if e not in expected_ids)
        inv.expect_equal("every_entity_on_exactly_one_survivor",
                         (missing, duplicated, unexpected, local_dups_a, local_dups_b),
                         ([], {}, [], [], []))
        for key, ledger in (("migrations", "ledger"), ("adoptions", "adoptions"),
                            ("deaths", "deaths")):
            inv.expect_equal(f"a_{key}_ledger_matches_metric", a_control[f"metric_{key}"],
                             a_control[ledger])
            inv.expect_equal(f"b_{key}_ledger_matches_metric",
                             b_report["control"][f"metric_{key}"], b_report["control"][ledger])
        inv.check("client_redirect_received", bool(redirect_result.get("redirect")),
                  str(redirect_result))
        inv.check("redirect_resumed_on_adopter_without_reauth",
                  resume_result.get("should_recover", False)
                  and resume_result.get("auth_result", -1) == 0
                  and resume_result.get("recovery_end", False), str(resume_result))
        inv.expect_equal("nothing_left_in_flight",
                         (len(plane._pending), len(plane._parked), b_report["pending"],
                          b_report["parked"], journal.in_flight_count()), (0, 0, 0, 0, 0))
        suspects = list(duplicated) + missing
        report = {
            "kind": "global_soak", "duration_s": round(time.monotonic() - t_start, 2),
            "entities": len(expected_ids),
            "knobs": {"epoch_ms": p.epoch_ms, "death_miss_epochs": p.death_miss_epochs,
                      "imbalance_enter": p.imbalance_enter,
                      "trunk_timeout_ms": p.trunk_timeout_ms},
            "directory": fed_cfg, "timeline": timeline,
            "migration": {"committed": committed_migrations,
                          "imbalance_after": round(flattened_imbalance, 4),
                          "leader_ledger": dict(control.ledger)},
            "adoption": {"dead": "c", "adopter": adopter, "killed_mid_burst": killed_mid_burst,
                         "a": {k: a_control[k] for k in ("adoptions", "deaths", "counters")},
                         "b": {k: b_report["control"][k]
                               for k in ("adoptions", "deaths", "counters")},
                         "declared_dead_after_s": round(t_dead - t_kill, 3)},
            "redirect": {"issued": redirect_result.get("redirect"),
                         "resume": {k: v for k, v in resume_result.items()
                                    if k != "recovery_channels"},
                         "resume_s": resume_s},
            "gateways": {"a": {"ledger": dict(plane.ledger), "control": a_control,
                               "journal": journal.report(), "events": plane.events[-400:],
                               "spatial": type(ctl).__name__},
                         "b": {k: v for k, v in b_report.items() if k != "placement"}},
            "census": {"expected": len(expected_ids), "on_a": len(a_placement),
                       "on_b": len(b_placement), "missing": missing,
                       "duplicated": {str(k): v for k, v in duplicated.items()},
                       "unexpected": unexpected,
                       "forensics": {"a": entity_forensics(P, [int(e) for e in suspects]),
                                     "b": {str(e): b_report.get("forensics", {}).get(str(e))
                                           for e in suspects}}},
            "boot": boot,
            "invariants": inv.summary(),
        }
        if notes:
            report["notes"] = notes
        return report
    finally:
        stop.set()
        if client_task is not None:
            client_task.cancel()
        stop_processes([b.proc, c.proc])
        if gw is not None:
            fed_teardown_gateway(P, gw)


def check_global_soak(doc: dict) -> list:
    """scripts/check_artifacts.py's ``_check_global_soak``: the global soak's
    acceptance bar beyond key presence (the migration, exactly-one-survivor,
    ledger == metrics and redirect-resume checks present; the census clean;
    a committed migration). Returns the errors."""
    errors: list = []
    names = {c.get("name") for c in doc.get("invariants", {}).get("checks", [])}
    for required in ("shard_migrations_committed", "imbalance_flattened_below_enter",
                     "every_entity_on_exactly_one_survivor",
                     "redirect_resumed_on_adopter_without_reauth"):
        if required not in names:
            errors.append(f"missing invariant check {required!r}")
    if not any(n and n.endswith("_ledger_matches_metric") for n in names):
        errors.append("no ledger==metrics invariant checks")
    census = doc.get("census", {})
    if census.get("missing") or census.get("duplicated") or census.get("unexpected"):
        errors.append(f"adoption census not clean: {census}")
    if not doc.get("migration", {}).get("committed"):
        errors.append("no committed cross-gateway shard migration")
    return errors


def global_soak_checks(r: dict) -> list:
    """17c's checks of one report, as (name, held, detail): every invariant
    of scripts/global_soak.py under its own name (all 14 present), the copy
    of scripts/check_artifacts.py's bar, tests/test_global_control.py's one
    adoption, both children gateways of the port with no module of JAX or
    of the JAX package (c's as its READY line said: it is killed before
    any report), every gateway on the host grid."""
    out = [(c["name"], c["ok"], c.get("detail", "")) for c in r["invariants"]["checks"]]
    names = [name for name, _, _ in out]
    ad, b = r["adoption"], r["gateways"]["b"]
    modules = {"b": (r["boot"]["b"].get("modules"), b.get("modules")),
               "c": (r["boot"]["c"].get("modules"),)}
    spatial = (r["gateways"]["a"].get("spatial"), b.get("spatial"))
    return out + [
        ("all_14_invariants_checked", names == list(GLOBAL_INVARIANTS), names),
        ("check_artifacts_global_soak", check_global_soak(r) == [], check_global_soak(r)),
        ("exactly_one_adoption", ad["a"]["adoptions"] + ad["b"]["adoptions"] == 1,
         (ad["a"]["adoptions"], ad["b"]["adoptions"])),
        ("children_import_no_jax",
         modules == {"b": ([], []), "c": ([],)}, modules),
        ("every_gateway_on_the_host_grid", spatial == (HOST_GRID,) * 2, spatial)]


def run_live(what: str, make) -> dict:
    """``asyncio.run(make())``, retried once (and said so) when a child never
    reached READY; any other failure stands."""
    import asyncio

    try:
        return asyncio.run(make())
    except ChildNotReady as e:
        print(f"{what}: retried once, a child never reached READY: {e}")
        return asyncio.run(make())


def boot_line(boot: dict) -> str:
    """The children's boots: Popen to READY, and its parts."""
    return "; ".join(f"{gw} {b['boot_s']:.2f} s (the script's imports {b['imports_s']:.2f} s, "
                     f"the port's host modules {b['modules_s']:.2f} s, the gateway's boot "
                     + ("in the soak" if b["gateway_s"] is None else f"{b['gateway_s']:.2f} s")
                     + f"; torch {'loaded' if 'torch' in b['modules'] else 'not loaded'})"
                     for gw, b in sorted(boot.items()))


def phase_trace_fed(P, p: dict, scratch: str, live: dict) -> dict:
    """17a: ``trace_fed_live`` held to the trace soak's phase-2 invariants."""
    t_phase = time.perf_counter()
    r = run_live("17a", lambda: trace_fed_live(P, p, scratch))
    for name, ok, detail in trace_fed_checks(r, live):
        check(ok, f"17a: {name}: {str(detail)[:300]}")
    t = r["trunk_stage"]
    print(f"17a trace federation live: scripts/trace_soak.py's phase 2 through the port, "
          f"gateway a in-process and gateway b a `chip_smoke.py --live-child trace` process (no "
          f"module of torch, of JAX or of the JAX package loaded), both on WORLD_SPATIAL's "
          f"Static2DSpatialController (the host grid: no device, by the script's design); "
          f"bursts {p['fed_burst']} + {p['fed_sever_burst']}, seed {p['seed']}; every check "
          f"held: " + ", ".join(name for name, _, _ in trace_fed_checks(r, live))
          + f" (the stages with 13b's); stitched traces {r['stitched_traces']}, committed {r['committed']}, severed "
          f"{r['severed']}, aborted {r['aborted']}; example {r['example']}; trunk stage "
          f"{t['count']} samples, mean / p50 / p99 {t['mean_ms']:.4f} / {t['p50_ms']:.4f} / "
          f"{t['p99_ms']:.4f} ms; {len(r['abort_dumps'])} handover_abort dumps Perfetto-valid; "
          f"b's ledger {r['b_ledger']}; child boot {boot_line(r['boot'])}; soak "
          f"{r['duration_s']} s, phase {time.perf_counter() - t_phase:.1f} s")
    return r


def phase_obs_fed(P, p: dict, scratch: str) -> dict:
    """17b: ``obs_fed_live`` held to the obs soak's phase-2 invariants."""
    t_phase = time.perf_counter()
    r = run_live("17b", lambda: obs_fed_live(P, p, scratch))
    for name, ok, detail in obs_fed_checks(r):
        check(ok, f"17b: {name}: {str(detail)[:300]}")
    print(f"17b obs federation live: scripts/obs_soak.py's phase 2 through the port, gateway a "
          f"in-process (ops surface on loopback) and gateway b a `chip_smoke.py --live-child "
          f"obs` process (no module of torch, of JAX or of the JAX package loaded), both on "
          f"WORLD_SPATIAL's Static2DSpatialController (the host grid: no device, by the "
          f"script's design), the SLO and control planes on at a {p['fed_epoch_ms']} ms epoch, "
          f"{p['fed_run_s']:g} s of traffic, seed {p['seed']}; every check held: "
          + ", ".join(name for name, _, _ in obs_fed_checks(r))
          + f"; digest exact on both legs, {r['labelsets_checked']} label sets of /fleet "
          f"checked, gateways in the fleet {r['gateways_in_fleet']}, leader "
          f"{r['leader']!r}; committed_handovers {r['committed_handovers']}, "
          f"trunk_rtt_slo_tracked {r['trunk_rtt_slo_tracked']}; child boot "
          f"{boot_line(r['boot'])}; soak {r['duration_s']} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return r


def phase_global_live(P, p: GlobalSoakParams, scratch: str) -> dict:
    """17c: ``run_global_soak`` held to every invariant of the script and to
    scripts/check_artifacts.py's bar."""
    t_phase = time.perf_counter()
    r = run_live("17c", lambda: run_global_soak(P, p, scratch))
    for name, ok, detail in global_soak_checks(r):
        check(ok, f"17c: {name}: {str(detail)[:300]}")
    ad, mig, rd, cen = r["adoption"], r["migration"], r["redirect"], r["census"]
    gws = {"a": r["gateways"]["a"]["control"], "b": r["gateways"]["b"]["control"]}
    print(f"17c global live: scripts/global_soak.py's run_global_soak through the port, "
          f"gateway a (the leader) in-process and gateways b and c `chip_smoke.py --live-child "
          f"global` processes (no module of torch, of JAX or of the JAX package loaded), all on WORLD_3's "
          f"Static2DSpatialController (the host grid: no device, by the script's design); "
          f"{p.base_entities} entities a gateway, a hotspot of {p.hotspot}, a kill burst of "
          f"{p.kill_burst}, {p.committed_to_c} committed to c, epoch {p.epoch_ms} ms, death "
          f"after {p.death_miss_epochs} missed epochs; every invariant of the script held "
          f"({len(r['invariants']['checks'])}) and check_artifacts' bar; migrations committed "
          f"{mig['committed']} (imbalance after {mig['imbalance_after']}, leader ledger "
          f"{mig['leader_ledger']}); c killed mid-burst {ad['killed_mid_burst']}, declared dead "
          f"{ad['declared_dead_after_s']} s after the kill, adopted by {ad['adopter']}; "
          + "; ".join(f"{g}: migrations {c['ledger']} = metric {c['metric_migrations']}, "
                      f"adoptions {c['adoptions']} = {c['metric_adoptions']}, deaths "
                      f"{c['deaths']} = {c['metric_deaths']}" for g, c in gws.items())
          + f"; redirect {rd['issued']}, resumed {rd['resume']}, resume seconds per gateway "
          f"tried {rd['resume_s']}; census {cen['on_a']} on a + {cen['on_b']} on b of "
          f"{cen['expected']}, none missing, duplicated or unexpected; timeline "
          f"{[(m['phase'], m['t']) for m in r['timeline']]}; children's boots "
          f"{boot_line(r['boot'])}; soak {r['duration_s']} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return r


def phase_fleet_live(K, live: dict) -> dict:
    """17a-17c, each with the kernels' counts set to 0 just before it and
    read just after: every gateway runs the host grid, so each path must
    launch no kernel. ``live``: 13b's stages, which phase 13 (or
    ``--fleet-live``) ran before in this process, as the trace soak runs its
    phase 1 before its phase 2. Returns {path: launches}."""
    import shutil
    import tempfile

    P = gateway_modules()
    t_phase = time.perf_counter()
    launches: dict = {}
    for path, run in (("trace_federation", lambda s: phase_trace_fed(P, trace_fed_params(), s,
                                                                     live)),
                      ("obs_federation", lambda s: phase_obs_fed(P, obs_fed_params(), s)),
                      ("global_soak", lambda s: phase_global_live(P, GlobalSoakParams(), s))):
        scratch = tempfile.mkdtemp(prefix=f"fleet-live-{path}-")
        K.reset_launch_counts()
        try:
            run(scratch)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        launches[path] = K.launch_counts()
        check(all(n == 0 for n in launches[path].values()),
              f"17 {path}: kernels launched on a host-grid path: {launches[path]}")
    print(f"phase 17: launches per path {launches} (every gateway on the host grid); "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches



# ---- phase 18: the abuse soak (the edge plane) through the port --------------
# scripts/abuse_soak.py's run_abuse_soak, the live acceptance of the edge plane
# (doc/edge_hardening.md): slow readers, malformed-frame sessions and a
# connect flood at once against an honest fleet. By the script's design its
# gateway has no spatial controller and its side planes are pinned off, so it
# runs no kernel. It runs whole in a ``--edge-child`` process (chip_host.py),
# which loads no torch: its RSS is a gateway's own, as in the JAX run.

EDGE_NOTE = ("phase 18: the edge plane's gateway has no spatial controller, by the script's "
             "design, and runs in a child that loads no torch")
EDGE_LEDGERS = (("quarantine", "conn_quarantine_total{reason}"),
                ("malformed", "malformed_frames_total{stage}"),
                ("egress_drops", "egress_dropped_total{reason}"),
                ("reaps", "conn_reaped_total{reason}"))


def check_abuse_soak(doc: dict) -> list:
    """scripts/check_artifacts.py's ``_check_abuse_soak``: the abuse soak's
    acceptance bar beyond key presence (three attacker classes, the honest
    census and delivery clean, the slow readers disconnected, the flood
    banned, four ledger==metric checks, RSS bounded). Returns the errors."""
    errors: list = []
    names = {c.get("name") for c in doc.get("invariants", {}).get("checks", [])}
    for required in ("honest_census_exact", "honest_delivery_exact",
                     "slow_readers_structurally_disconnected", "malformed_counted_at_framing",
                     "flood_sources_banned", "rss_growth_bounded_mb"):
        if required not in names:
            errors.append(f"missing invariant check {required!r}")
    ledger_checks = {n for n in names if n and n.endswith("_ledger_matches_metric")}
    if len(ledger_checks) < 4:
        errors.append("fewer than 4 ledger==metric invariant checks "
                      f"({sorted(ledger_checks)})")
    classes = doc.get("attackers", {}).get("classes", [])
    if len(classes) < 3:
        errors.append(f"fewer than 3 attacker classes ({classes})")
    census = doc.get("census", {})
    if census.get("survivors") != census.get("expected") or census.get("honest_disconnects"):
        errors.append(f"honest census not clean: {census}")
    delivery = doc.get("delivery", {})
    if delivery.get("missing") or not delivery.get("frames_sent"):
        errors.append(f"delivery accounting not clean: {delivery}")
    rss = doc.get("rss", {})
    if rss.get("growth_mb") is None or rss.get("bound_mb") is None \
            or rss["growth_mb"] > rss["bound_mb"]:
        errors.append(f"rss bound not proven: {rss}")
    return errors


def abuse_soak_checks(r: dict) -> list:
    """Phase 18's checks of one report, as (name, held, detail): every
    invariant of scripts/abuse_soak.py under its own name (all 22 present,
    in its order), the copy of scripts/check_artifacts.py's bar, and the
    child a gateway of the port with no module of torch, of JAX or of the
    JAX package loaded (at its READY line and at its end)."""
    out = [(c["name"], c["ok"], c.get("detail", "")) for c in r["invariants"]["checks"]]
    names = [name for name, _, _ in out]
    modules = (r["boot"].get("modules"), r.get("modules"))
    return out + [
        ("all_22_invariants_checked", names == list(chip_host.ABUSE_INVARIANTS), names),
        ("check_artifacts_abuse_soak", check_abuse_soak(r) == [], check_abuse_soak(r)),
        ("child_loads_no_torch_and_no_jax", modules == ([], []), modules)]


def run_edge_child(scratch: str) -> dict:
    """``chip_smoke.py --edge-child REPORT`` run to its end: the soak's
    report with the child's boot (READY's parts and ``boot_s``, Popen to
    READY). Fails if the child does not boot or does not end."""
    p = AbuseSoakParams()
    log_path = os.path.join(scratch, "edge_child.log")
    report_path = os.path.join(scratch, "edge_report.json")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--edge-child", report_path],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=log, text=True)
    try:
        line = proc.stdout.readline()
        boot_s = time.perf_counter() - t0
        out, _ = proc.communicate(timeout=p.attack_s + p.quiesce_s + 90.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise PhaseFailed("18: the --edge-child did not end in time")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        tail = f.read()[-600:]
    check(line.startswith("READY"), f"18: the --edge-child never printed READY: {tail}")
    check(proc.returncode == 0 and "OK report" in out,
          f"18: the --edge-child exited {proc.returncode}: {tail}")
    with open(report_path) as f:
        r = json.load(f)
    r["boot"] = dict(json.loads(line[len("READY"):]), boot_s=round(boot_s, 3))
    return r


def phase_edge_live(K) -> dict:
    """Phase 18: ``run_abuse_soak`` at AbuseSoakParams(), cut nowhere, in a
    ``--edge-child``, held to every invariant of the script and to
    scripts/check_artifacts.py's bar, with the kernels' counts set to 0
    just before it and read just after. Returns {path: launches}."""
    import shutil
    import tempfile

    p = AbuseSoakParams()
    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="edge-live-")
    K.reset_launch_counts()
    try:
        r = run_edge_child(scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    launches = K.launch_counts()
    for name, ok, detail in abuse_soak_checks(r):
        check(ok, f"18: {name}: {str(detail)[:300]}")
    check(all(n == 0 for n in launches.values()),
          f"18: kernels launched on the edge path: {launches}")
    a, e, m = r["attackers"], r["edge"], r["metrics"]
    print(f"18 abuse soak live: scripts/abuse_soak.py's run_abuse_soak through the port in a "
          f"`chip_smoke.py --edge-child` process (no module of torch, of JAX or of the JAX "
          f"package loaded), the gateway with no spatial controller and its side planes off, "
          f"by the script's design; AbuseSoakParams() cut nowhere: attack {p.attack_s:g} s, "
          f"quiesce {p.quiesce_s:g} s, {p.honest} honest clients at {p.msg_rate:g} msg/s, "
          f"{p.slow_readers} slow readers under a {p.flood_rate:g}/s flood of "
          f"{p.flood_payload} B, {p.malformed} malformed-frame sources, {p.flood_ips} "
          f"connect-flood IPs, auth deadline {p.auth_deadline_ms} ms, seed {p.seed:#x}; every "
          f"invariant of the script held ({len(r['invariants']['checks'])}) and "
          f"check_artifacts' bar")
    print(f"18 sessions per attacker class: slow readers {a['slow_reader']} (from "
          f"{chip_host.ATTACKER_SOURCES['slow_reader']}x), malformed frames "
          f"{a['malformed_frame']} (from {chip_host.ATTACKER_SOURCES['malformed_frame']}x), "
          f"connect flood {a['connect_flood']} (from "
          f"{chip_host.ATTACKER_SOURCES['connect_flood']}x); banned {e['banned_ips']}")
    print("18 edge ledgers beside their metrics: " + "; ".join(
        f"{led} {e[led]} = {metric} {m[led]}" for led, metric in EDGE_LEDGERS))
    print(f"18 census {len(r['census']['survivors'])} survivors = expected "
          f"{len(r['census']['expected'])} (master + {p.honest} honest), honest disconnects "
          f"{r['census']['honest_disconnects']}; delivery {r['delivery']['frames_drained']} "
          f"drained of {r['delivery']['frames_sent']} sent, missing "
          f"{r['delivery']['missing']}; RSS base / peak / final {r['rss']['base_mb']} / "
          f"{r['rss']['peak_mb']} / {r['rss']['final_mb']} MB, growth "
          f"{r['rss']['growth_mb']} MB against {r['rss']['bound_mb']} MB")
    print(f"phase 18: launches {launches} ({EDGE_NOTE}); soak {r['duration_s']} s "
          f"(gateway and fleet up in {r['up_s']} s); child boot {boot_line({'edge': r['boot']})}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"abuse_soak": launches}


# ---- phase 19: the failover and balance soaks on the GPU controller ----------
#
# scripts/failover_soak.py loses two spatial servers for good (the first
# mid-handover burst, the second during the first failover epoch) and proves
# the re-host, the journal and the ownerless-drop accounting;
# scripts/balance_soak.py herds the world into one server's quadrant, proves
# the balancer's planned migrations, then kills a migration's destination
# inside its freeze window. Both boot scripts/chaos_soak.py's gateway with the
# device controller on the cells plane, so K1 and K2 run on every engine tick.
# Each script's run, from its warmup to its books, is one generator here
# (``failover_schedule``, ``balance_schedule``) that yields the seconds the
# script sleeps: 19a drives it on a fixed clock through ``LossWorld`` (stub
# servers, one GLOBAL tick at a time) against a CPU leg; 19b and 19c drive it
# live (``LiveLoss``: TCP listeners, real sockets, asyncio sleeps).

FAILOVER_INVARIANTS = (
    "one_server_lost_event_per_kill", "server_lost_metric_matches_ledger",
    "all_cells_owned_after_failover", "every_orphan_cell_rehosted",
    "failover_pass_under_deadline", "every_kill_orphaned_cells",
    "rehost_within_window_plus_deadline", "rehost_accounting_exact",
    "journal_metric_matches_ledger", "journal_prepared_equals_committed_plus_aborted",
    "journal_nothing_in_flight", "no_lost_entity_tracking", "every_entity_in_exactly_one_cell",
    "every_entity_channel_has_live_owner", "ownerless_drops_exact", "ownerless_window_probed",
    "global_tick_p99_bounded", "post_failover_tick_p99_bounded", "handovers_after_failover")
BALANCE_INVARIANTS = (
    "no_migration_while_balanced", "hotspot_migrations_committed",
    "steady_state_entity_imbalance_under_threshold", "migration_metric_matches_ledger",
    "migrations_planned_equals_committed_plus_aborted", "no_migration_left_in_flight",
    "no_frozen_crossing_left_behind", "per_epoch_commits_within_budget",
    "no_cell_migrates_twice_within_cooldown", "kill_mid_migration_landed",
    "crash_mid_migration_aborts_to_old_owner", "no_lost_entity_tracking",
    "every_entity_in_exactly_one_cell", "journal_prepared_equals_committed_plus_aborted",
    "journal_nothing_in_flight", "global_tick_p99_bounded")
# scripts/check_artifacts.py's required keys of SOAK_FAILOVER_* and SOAK_BALANCE_*.
ARTIFACT_KEYS = {"failover_soak": {"kind", "invariants", "failover", "journal", "kills"},
                 "balance_soak": {"kind", "invariants", "balancer", "journal", "kill"}}
BALANCER_KNOBS = ("imbalance_enter", "imbalance_exit", "hold_ticks", "epoch_ticks",
                  "budget_per_epoch", "cooldown_ticks", "min_entity_delta", "freeze_min_ticks")
FAILOVER_KILLS = ((1, "kill-1-mid-handover-burst"), (2, "kill-2-during-failover"))
PROBE_PREFIX = b"orfn"  # the failover soak's probe frames


def failover_scenario() -> dict:
    """scripts/failover_soak.py's default_scenario: ambient stalls only (the
    transport fault is the deliberate server kill)."""
    return {"name": "failover-weather", "seed": SOAK_SCENARIO_SEED,
            "config_overrides": {"CellBucket": 6}, "faults": [
                {"point": "device.dispatch_stall", "every_n": 25, "stall_ms": 30,
                 "max_fires": 60},
                {"point": "channel.tick_budget", "every_n": 400, "stall_ms": 10,
                 "max_fires": 40}]}


def balance_scenario() -> dict:
    """scripts/balance_soak.py's default_scenario: mild dispatch stalls (the
    fault is the skew, and the destination kill)."""
    return {"name": "balance-weather", "seed": SOAK_SCENARIO_SEED,
            "config_overrides": {"CellBucket": 8}, "faults": [
                {"point": "device.dispatch_stall", "every_n": 40, "stall_ms": 20,
                 "max_fires": 50}]}


def failover_params(**kw) -> dict:
    """scripts/failover_soak.py's FailoverSoakParams (its paths apart), its
    scenario ``failover_scenario()``."""
    return dict(dict(warmup_s=8.0, aftermath_s=12.0, quiesce_s=8.0, clients=12, entities=128,
                     msg_rate=20.0, storm_size=48, kills=2, recover_window_s=1.5,
                     rehost_deadline_s=3.0, settle_margin_s=3.0, probe_frames=20,
                     tick_p99_bound_s=1.5, global_tick_ms=33, entity_capacity=256,
                     query_capacity=32, scenario=failover_scenario()), **kw)


def balance_params(**kw) -> dict:
    """scripts/balance_soak.py's BalanceSoakParams (its paths apart), its
    scenario ``balance_scenario()``."""
    return dict(dict(warmup_s=6.0, hotspot_s=22.0, aftermath_s=8.0, quiesce_s=8.0, clients=10,
                     entities=128, msg_rate=20.0, kill_mid_migration=True, kill_phase_s=14.0,
                     recover_window_s=1.5, imbalance_enter=1.5, imbalance_exit=1.2,
                     hold_ticks=3, epoch_ticks=90, budget_per_epoch=2, cooldown_ticks=240,
                     min_entity_delta=8, freeze_min_ticks=6, kill_freeze_min_ticks=45,
                     tick_p99_bound_s=1.5, global_tick_ms=33, entity_capacity=256,
                     query_capacity=32, scenario=balance_scenario()), **kw)


# 19a's timelines on the fixed clock: the scripts' knobs and weather, their
# phases shortened (each kill's window, re-host and probes are the scripts').
FAILOVER_LOCKSTEP = dict(warmup_s=3.0, aftermath_s=7.0, quiesce_s=2.0)
BALANCE_LOCKSTEP = dict(warmup_s=2.0, hotspot_s=8.0, kill_phase_s=7.0, aftermath_s=2.0,
                        quiesce_s=2.0)


def loss_pins(P, dev, p: dict, balancer: bool) -> None:
    """The failover soak's pins (``balancer`` False) or the balance soak's:
    development mode; the device tables of ``p``; the ladder, the flight
    recorder, the device guard, the SLO plane, partitioning and federation
    off; recoverable server connections with ``recover_window_s``; failover
    on (its re-host deadline from ``p`` in the failover soak); the balancer
    off, or on with the balance soak's knobs; GLOBAL at ``global_tick_ms``
    (fan-out 50 ms), SPATIAL and ENTITY 50 / 100 ms; the engine on ``dev``."""
    s = P.settings.global_settings
    s.development = True
    if P.port:
        s.spatial_device = dev.type
    s.tpu_entity_capacity, s.tpu_query_capacity = p["entity_capacity"], p["query_capacity"]
    s.overload_enabled = s.trace_enabled = s.device_guard_enabled = s.slo_enabled = False
    P.tracing.recorder.configure(enabled=False)
    s.partition_enabled = False
    P.federation.reset_federation()
    s.federation_config = ""
    s.server_conn_recoverable = True
    s.server_conn_recover_timeout_ms = int(p["recover_window_s"] * 1000)
    s.failover_enabled = True
    s.balancer_enabled = balancer
    if balancer:
        for knob in BALANCER_KNOBS:
            setattr(s, f"balancer_{knob}", p[knob])
    else:
        s.failover_rehost_deadline_s = p["rehost_deadline_s"]
    cs, ct = P.settings.ChannelSettings, P.types.ChannelType
    s.channel_settings = {
        ct.GLOBAL: cs(tick_interval_ms=p["global_tick_ms"], default_fanout_interval_ms=50),
        ct.SPATIAL: cs(tick_interval_ms=50, default_fanout_interval_ms=100),
        ct.ENTITY: cs(tick_interval_ms=50, default_fanout_interval_ms=100)}


class LossWorldBase:
    """The reads both schedules make of a world. A world also holds ``P``,
    the controller ``ctl``, the entity sim ``sim``, ``t_start``,
    ``timeline``, ``probe_sent`` and ``probe_received``, and answers
    ``start``, ``kill``, ``probe``, ``stop_sending`` and ``frames_sent``."""

    def spatial_channels(self) -> dict:
        s = self.P.settings.global_settings
        return {cid: ch for cid, ch in self.P.channel.all_channels().items()
                if s.spatial_channel_id_start <= cid < s.entity_channel_id_start}

    def all_cells_owned(self) -> bool:
        cells = self.spatial_channels()
        return len(cells) == 16 and all(ch.has_owner() for ch in cells.values())

    def server_conn(self, pit: str):
        for conn in self.P.connection.all_connections().values():
            if conn.pit == pit and not conn.is_closing():
                return conn
        return None

    def server_entity_loads(self) -> dict:
        """scripts/balance_soak.py's server_entity_loads: conn id -> entities
        resident in its owned cells."""
        out: dict = {}
        for ch in self.spatial_channels().values():
            if not ch.has_owner():
                continue
            ents = getattr(ch.get_data_message(), "entities", None)
            owner = ch.get_owner().id
            out[owner] = out.get(owner, 0) + (len(ents) if ents is not None else 0)
        return out


def entity_imbalance(loads: dict) -> float:
    """scripts/balance_soak.py's entity_imbalance: max / mean of the loads."""
    if not loads:
        return 0.0
    mean = sum(loads.values()) / len(loads)
    return (max(loads.values()) / mean) if mean > 0 else 0.0


def invariant_summary(checks: list) -> dict:
    """An InvariantChecker summary of (name, held, detail) checks."""
    return {"ok": all(ok for _, ok, _ in checks),
            "checks": [{"name": n, "ok": bool(ok), "detail": str(d)[:300]} for n, ok, d in checks]}


def failover_schedule(w, p: dict):
    """scripts/failover_soak.py's run_failover_soak from its baseline to its
    books, against the world ``w``: a generator yielding the seconds the
    script sleeps; it returns the soak's report. The scenario armed, a
    warmup with a storm, then each kill: a storm marches a crowd, 150 ms
    later server ``soak-spatial-<i>``'s socket dies (``w.kill``), an
    orphaned cell is probed (``w.probe``) until the recovery window's last
    200 ms, and the world jitters until every cell is owned again; the
    aftermath's storms on the shrunken fleet; the clients stop, the
    scenario is disarmed, and the books after ``quiesce_s``."""
    P, sim = w.P, w.sim
    inv, plane = P.invariants, P.failover.plane
    baseline = inv.scrape()
    P.chaos.arm(p["scenario"])
    w.start()
    warm_until = time.monotonic() + p["warmup_s"]
    crowd = sim.storm_gather()
    while time.monotonic() < warm_until:
        sim.jitter_step()
        yield 0.1
    sim.disperse(crowd)
    kills: list = []
    for index, label in FAILOVER_KILLS[:p["kills"]]:
        pit = f"soak-spatial-{index}"
        conn = w.server_conn(pit)
        if conn is None:
            raise PhaseFailed(f"victim {pit} not found/alive")
        owned = sorted(cid for cid, ch in w.spatial_channels().items() if ch.get_owner() is conn)
        sim.storm_gather()
        yield 0.15
        t_kill = time.monotonic()
        w.kill(index, label)
        rec = dict(label=label, pit=pit, conn_id=conn.id, t=round(t_kill - w.t_start, 2),
                   owned_cells=owned)
        orphan_deadline = t_kill + 2.0
        while time.monotonic() < orphan_deadline and w.all_cells_owned():
            yield 0.02
        rec["orphaned"] = not w.all_cells_owned()
        if owned:
            w.probe(owned[0], t_kill + p["recover_window_s"] - 0.2)
        deadline = t_kill + p["recover_window_s"] + p["rehost_deadline_s"] + p["settle_margin_s"]
        while time.monotonic() < deadline:
            sim.jitter_step()
            if w.all_cells_owned():
                break
            yield 0.1
        rec["rehosted_in_s"] = (round(time.monotonic() - t_kill, 2)
                                if w.all_cells_owned() else None)
        kills.append(rec)
    after_rehost = inv.scrape()
    aft_until = time.monotonic() + p["aftermath_s"]
    crowd, storm_at = [], time.monotonic() + 1.0
    while time.monotonic() < aft_until:
        sim.jitter_step()
        if time.monotonic() >= storm_at:
            if crowd:
                sim.disperse(crowd)
                crowd = []
            if time.monotonic() < aft_until - 5.0:
                crowd = sim.storm_gather()
            storm_at += 4.0
        yield 0.1
    if crowd:
        sim.disperse(crowd)
    w.stop_sending()
    fires = dict(P.chaos.chaos.fire_counts())
    P.chaos.disarm()
    yield p["quiesce_s"]
    now = inv.scrape()
    d, d_post = inv.delta(now, baseline), inv.delta(now, after_rehost)
    cells = w.spatial_channels()
    report = dict(
        kind="failover_soak", config=os.path.basename(TRACE_CELLS_CONFIG),
        config_overrides=dict(p["scenario"]["config_overrides"]),
        duration_s=round(time.monotonic() - w.t_start, 2),
        phases={k: p[k] for k in ("warmup_s", "recover_window_s", "rehost_deadline_s",
                                  "aftermath_s", "quiesce_s")},
        clients=p["clients"], entities=p["entities"], scenario=p["scenario"], kills=kills,
        failover=plane.report(), journal=P.failover.journal.report(), timeline=w.timeline,
        chaos=fires,
        books=dict(
            soak_census(P, w.ctl, sim.entity_ids),
            servers_lost=plane.ledger["servers_lost"],
            server_lost_metric=int(inv.sample_total(d, "server_lost_total")),
            cells=len(cells), cells_owned=sum(1 for ch in cells.values() if ch.has_owner()),
            rehost_metric=int(inv.sample_total(d, "failover_rehost_total")),
            journal_metric={dict(labels)["state"]: int(v) for (name, labels), v in d.items()
                            if name == "handover_journal_total" and v},
            ownerless_entities=[
                eid for eid in sim.entity_ids
                if (ech := P.channel.get_channel(eid)) is not None and not ech.is_removing()
                and not ech.has_owner()]),
        stats=dict(
            client_frames_sent=w.frames_sent(), probe_frames_sent=w.probe_sent,
            probe_frames_forwarded=w.probe_received,
            ownerless_drops=int(inv.sample_total(d, "ownerless_drops_total")),
            cells_rehosted=plane.ledger["cells_rehosted"],
            entities_repointed=plane.ledger["entities_repointed"],
            handovers_total=int(inv.sample_total(d, "handovers_total")),
            handovers_after_failover=int(inv.sample_total(d_post, "handovers_total")),
            global_tick_p99_s=inv.histogram_quantile(d, "channel_tick_duration", 0.99,
                                                     channel_type="GLOBAL"),
            post_failover_tick_p99_s=inv.histogram_quantile(d_post, "channel_tick_duration",
                                                            0.99, channel_type="GLOBAL"),
            device_step_p99_s=inv.histogram_quantile(d, "tpu_spatial_step_seconds", 0.99)))
    report["invariants"] = invariant_summary(failover_soak_checks(report, p))
    return report


def failover_soak_checks(r: dict, p: dict) -> list:
    """scripts/failover_soak.py's 19 invariants of a report, under its names
    and in its order, as (name, held, detail)."""
    b, st, kills = r["books"], r["stats"], r["kills"]
    events = r["failover"]["events"]
    orphans = sum(len(e["orphan_cells"]) for e in events)
    rehosts = sum(len(e["rehosted"]) for e in events)
    worst_ms = max((e["duration_ms"] for e in events), default=0.0)
    budget = p["recover_window_s"] + p["rehost_deadline_s"] + p["settle_margin_s"]
    slow = [k for k in kills if k["rehosted_in_s"] is None or k["rehosted_in_s"] > budget]
    jc = r["journal"]["counts"]
    expected_drops = st["probe_frames_sent"] - st["probe_frames_forwarded"]
    p99, p99_post = st["global_tick_p99_s"], st["post_failover_tick_p99_s"]
    bound = p["tick_p99_bound_s"]
    return [
        ("one_server_lost_event_per_kill", b["servers_lost"] == len(kills),
         (b["servers_lost"], len(kills))),
        ("server_lost_metric_matches_ledger", b["server_lost_metric"] == b["servers_lost"],
         (b["server_lost_metric"], b["servers_lost"])),
        ("all_cells_owned_after_failover", b["cells"] == b["cells_owned"] == 16,
         f"{b['cells_owned']}/16"),
        ("every_orphan_cell_rehosted", rehosts == orphans, (rehosts, orphans)),
        ("failover_pass_under_deadline", worst_ms / 1000.0 <= p["rehost_deadline_s"], worst_ms),
        ("every_kill_orphaned_cells", [k["label"] for k in kills if not k["orphaned"]] == [],
         [k["label"] for k in kills if not k["orphaned"]]),
        ("rehost_within_window_plus_deadline", slow == [],
         [(k["label"], k["rehosted_in_s"]) for k in kills]),
        ("rehost_accounting_exact",
         (b["rehost_metric"], st["cells_rehosted"]) == (rehosts, rehosts),
         (b["rehost_metric"], st["cells_rehosted"], rehosts)),
        ("journal_metric_matches_ledger", b["journal_metric"] == jc, (b["journal_metric"], jc)),
        ("journal_prepared_equals_committed_plus_aborted",
         jc.get("prepared", 0) == jc.get("committed", 0) + jc.get("aborted", 0), jc),
        ("journal_nothing_in_flight", r["journal"]["in_flight"] == 0, r["journal"]["in_flight"]),
        ("no_lost_entity_tracking", b["lost_tracking"] == [], b["lost_tracking"]),
        ("every_entity_in_exactly_one_cell", (b["missing"], b["duped"]) == ([], []),
         (b["missing"], b["duped"])),
        ("every_entity_channel_has_live_owner", b["ownerless_entities"] == [],
         b["ownerless_entities"]),
        ("ownerless_drops_exact", st["ownerless_drops"] == expected_drops,
         f"drops={st['ownerless_drops']} sent={st['probe_frames_sent']} "
         f"received={st['probe_frames_forwarded']}"),
        ("ownerless_window_probed", st["probe_frames_sent"] > 0, st["probe_frames_sent"]),
        ("global_tick_p99_bounded", p99 is not None and p99 <= bound, p99),
        ("post_failover_tick_p99_bounded", p99_post is not None and p99_post <= bound, p99_post),
        ("handovers_after_failover", st["handovers_after_failover"] > 0,
         st["handovers_after_failover"])]


def balance_schedule(w, p: dict):
    """scripts/balance_soak.py's run_balance_soak from its baseline to its
    books, against the world ``w`` (a generator, as ``failover_schedule``):
    the scenario armed; a uniform warmup; the whole crowd herded into
    quadrant (0, 0) and jittered there for at least ``hotspot_s`` (up to
    twice that while the per-server load stays over the enter threshold or
    a migration is in flight); the steady-state loads once the last
    migration resolved; then, with ``kill_mid_migration``, the freeze
    widened to ``kill_freeze_min_ticks``, the crowd dispersed and re-herded
    into quadrant (1, 1), and the first migration's destination killed while
    it drains; the aftermath; the books after ``quiesce_s``."""
    P, sim, ctl = w.P, w.sim, w.ctl
    inv, bal = P.invariants, P.balancer.balancer
    rng = sim.rng
    baseline = inv.scrape()
    P.chaos.arm(p["scenario"])
    w.start()

    def quadrant_bounds(sx: int, sy: int) -> tuple:
        sgc = -(-ctl.grid_cols // ctl.server_cols)
        sgr = -(-ctl.grid_rows // ctl.server_rows)
        x0 = ctl.world_offset_x + sx * sgc * ctl.grid_width + 1.0
        z0 = ctl.world_offset_z + sy * sgr * ctl.grid_height + 1.0
        return x0, z0, x0 + sgc * ctl.grid_width - 2.0, z0 + sgr * ctl.grid_height - 2.0

    def herd(sx: int, sy: int) -> None:
        x0, z0, x1, z1 = quadrant_bounds(sx, sy)
        for eid in sim.entity_ids:
            sim._move(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))

    def quadrant_jitter(sx: int, sy: int) -> None:
        x0, z0, x1, z1 = quadrant_bounds(sx, sy)
        for eid in rng.sample(sim.entity_ids, max(1, len(sim.entity_ids) // 8)):
            x, z = sim.positions[eid]
            sim._move(eid, min(max(x + rng.uniform(-8, 8), x0), x1),
                      min(max(z + rng.uniform(-8, 8), z0), z1))

    warm_until = time.monotonic() + p["warmup_s"]
    while time.monotonic() < warm_until:
        sim.jitter_step()
        yield 0.1
    committed_at_warmup = bal.ledger.get("committed", 0)
    herd(0, 0)
    hot_min = time.monotonic() + p["hotspot_s"]
    hot_cap = time.monotonic() + p["hotspot_s"] * 2
    while time.monotonic() < hot_min or (
            time.monotonic() < hot_cap
            and (entity_imbalance(w.server_entity_loads()) >= p["imbalance_enter"]
                 or bal.migration_in_flight() is not None)):
        quadrant_jitter(0, 0)
        yield 0.1
    hotspot_committed = bal.ledger.get("committed", 0)
    settle_until = time.monotonic() + 3.0
    while time.monotonic() < settle_until and bal.migration_in_flight() is not None:
        yield 0.1
    steady_loads = w.server_entity_loads()
    steady_imbalance = entity_imbalance(steady_loads)
    kill_rec, fault_log = None, []
    if p["kill_mid_migration"]:
        P.settings.global_settings.balancer_freeze_min_ticks = p["kill_freeze_min_ticks"]
        sim.disperse(list(sim.entity_ids))
        yield 1.5
        herd(1, 1)
        kill_until = time.monotonic() + p["kill_phase_s"]
        while time.monotonic() < kill_until:
            quadrant_jitter(1, 1)
            mig = bal.migration_in_flight()
            if mig is not None and kill_rec is None:
                dst_pit = getattr(mig.dst_conn, "pit", "")
                idx = int(dst_pit.rsplit("-", 1)[1]) if dst_pit.startswith("soak-spatial-") \
                    else None
                if idx is not None and idx < 4:
                    cell_id = mig.cell_id
                    aborted_before = bal.ledger.get("aborted", 0)
                    w.kill(idx, "kill-mid-migration")
                    t_kill = time.monotonic()
                    while bal.migration_in_flight() is mig and time.monotonic() < t_kill + 5.0:
                        yield 0.05
                    abort_ev = next((e for e in reversed(bal.events)
                                     if e["cell"] == cell_id and e["result"] != "committed"),
                                    None)
                    kill_rec = dict(
                        dst_pit=dst_pit, cell=cell_id, t=round(t_kill - w.t_start, 2),
                        resolved_in_s=round(time.monotonic() - t_kill, 2),
                        aborted=bal.ledger.get("aborted", 0) > aborted_before,
                        owner_is_src_after_abort=bool(
                            abort_ev is not None and abort_ev.get("owner_rolled_back")))
                else:
                    fault_log.append(f"kill skipped: dst {dst_pit!r} unmapped")
            yield 0.1
        if kill_rec is None:
            fault_log.append("no migration observed in kill phase")
    aft_until = time.monotonic() + p["aftermath_s"]
    while time.monotonic() < aft_until:
        sim.jitter_step()
        yield 0.1
    w.stop_sending()
    fires = dict(P.chaos.chaos.fire_counts())
    P.chaos.disarm()
    yield p["quiesce_s"]
    d = inv.delta(inv.scrape(), baseline)
    breport = bal.report()
    report = dict(
        kind="balance_soak", config=os.path.basename(TRACE_CELLS_CONFIG),
        config_overrides=dict(p["scenario"]["config_overrides"]),
        duration_s=round(time.monotonic() - w.t_start, 2),
        phases=dict(warmup_s=p["warmup_s"], hotspot_s=p["hotspot_s"],
                    kill_phase_s=p["kill_phase_s"] if p["kill_mid_migration"] else 0,
                    aftermath_s=p["aftermath_s"], quiesce_s=p["quiesce_s"]),
        clients=p["clients"], entities=p["entities"],
        balancer_knobs={k: p[k] for k in BALANCER_KNOBS if k != "min_entity_delta"},
        scenario=p["scenario"], balancer=breport, kill=kill_rec,
        steady_state=dict(server_entities={str(k): v for k, v in sorted(steady_loads.items())},
                          entity_imbalance=round(steady_imbalance, 3)),
        failover=P.failover.plane.report(), journal=P.failover.journal.report(),
        timeline=w.timeline, chaos=fires, notes=fault_log,
        books=dict(
            soak_census(P, ctl, sim.entity_ids), committed_at_warmup=committed_at_warmup,
            hotspot_committed=hotspot_committed, steady_imbalance=steady_imbalance,
            metric_results={dict(labels)["result"]: int(v) for (name, labels), v in d.items()
                            if name == "balancer_migrations_total" and v},
            in_flight=bal.migration_in_flight() is not None,
            frozen=(sorted(bal.frozen_cells), len(bal._frozen_crossings))),
        stats=dict(
            client_frames_sent=w.frames_sent(),
            migrations_committed=bal.ledger.get("committed", 0),
            migrations_aborted=bal.ledger.get("aborted", 0),
            migrations_vetoed=bal.ledger.get("vetoed", 0),
            handovers_total=int(inv.sample_total(d, "handovers_total")),
            steady_entity_imbalance=round(steady_imbalance, 3),
            global_tick_p99_s=inv.histogram_quantile(d, "channel_tick_duration", 0.99,
                                                     channel_type="GLOBAL"),
            device_step_p99_s=inv.histogram_quantile(d, "tpu_spatial_step_seconds", 0.99)))
    report["invariants"] = invariant_summary(balance_soak_checks(report, p))
    return report


def balance_soak_checks(r: dict, p: dict) -> list:
    """scripts/balance_soak.py's invariants of a report, under its names and
    in its order (16; the two of the kill only with ``kill_mid_migration``,
    the second only once the kill landed), as (name, held, detail)."""
    b, ledger = r["books"], r["balancer"]["ledger"]
    commits = [e for e in r["balancer"]["events"] if e["result"] == "committed"]
    per_epoch: dict = {}
    for e in commits:
        per_epoch[e["epoch"]] = per_epoch.get(e["epoch"], 0) + 1
    over_budget = {ep: n for ep, n in per_epoch.items() if n > p["budget_per_epoch"]}
    by_cell: dict = {}
    for e in commits:
        by_cell.setdefault(e["cell"], []).append(e["resolved_tick"])
    flaps = [(cell, a, c) for cell, ticks in by_cell.items()
             for a, c in zip(sorted(ticks), sorted(ticks)[1:]) if c - a < p["cooldown_ticks"]]
    jc, p99 = r["journal"]["counts"], r["stats"]["global_tick_p99_s"]
    checks = [
        ("no_migration_while_balanced", b["committed_at_warmup"] == 0, b["committed_at_warmup"]),
        ("hotspot_migrations_committed", b["hotspot_committed"] > 0, b["hotspot_committed"]),
        ("steady_state_entity_imbalance_under_threshold",
         b["steady_imbalance"] <= p["imbalance_enter"],
         (b["steady_imbalance"], r["steady_state"]["server_entities"])),
        ("migration_metric_matches_ledger", b["metric_results"] == ledger,
         (b["metric_results"], ledger)),
        ("migrations_planned_equals_committed_plus_aborted",
         ledger.get("planned", 0) == ledger.get("committed", 0) + ledger.get("aborted", 0),
         ledger),
        ("no_migration_left_in_flight", not b["in_flight"], b["in_flight"]),
        ("no_frozen_crossing_left_behind", tuple(b["frozen"]) == ([], 0), b["frozen"]),
        ("per_epoch_commits_within_budget", over_budget == {}, per_epoch),
        ("no_cell_migrates_twice_within_cooldown", flaps == [], flaps)]
    if p["kill_mid_migration"]:
        checks.append(("kill_mid_migration_landed", r["kill"] is not None, r["notes"]))
        if r["kill"] is not None:
            checks.append(("crash_mid_migration_aborts_to_old_owner",
                           r["kill"]["aborted"] and r["kill"]["owner_is_src_after_abort"],
                           r["kill"]))
    return checks + [
        ("no_lost_entity_tracking", b["lost_tracking"] == [], b["lost_tracking"]),
        ("every_entity_in_exactly_one_cell", (b["missing"], b["duped"]) == ([], []),
         (b["missing"], b["duped"])),
        ("journal_prepared_equals_committed_plus_aborted",
         jc.get("prepared", 0) == jc.get("committed", 0) + jc.get("aborted", 0), jc),
        ("journal_nothing_in_flight", r["journal"]["in_flight"] == 0, r["journal"]["in_flight"]),
        ("global_tick_p99_bounded", p99 is not None and p99 <= p["tick_p99_bound_s"], p99)]


# Each soak's run, its params, 19a's timeline and the seed its entity sim
# xors into the scenario's.
SCHEDULES = {"failover": NS(run=failover_schedule, params=failover_params,
                            lockstep=FAILOVER_LOCKSTEP, sim_seed=0xFA11),
             "balance": NS(run=balance_schedule, params=balance_params,
                           lockstep=BALANCE_LOCKSTEP, sim_seed=0xBA1A)}


def loss_sim(P, ctl, schedule: str, p: dict) -> EntitySim:
    """The soak's entity sim: ``entities`` at seeded positions, storms of the
    failover soak's ``storm_size`` (the balance soak's are 48, no param),
    seeded from the scenario's seed xor the soak's own."""
    from random import Random

    return EntitySim(P, ctl, p["entities"], p.get("storm_size", 48),
                     Random(p["scenario"]["seed"] ^ SCHEDULES[schedule].sim_seed))


class LossConn(ElasticConn):
    """``ElasticConn`` that also counts the failover soak's probe frames it
    is forwarded, as the script's spatial-server drain does."""

    def __init__(self, P, conn_id: int, kind: str):
        super().__init__(P, conn_id, kind)
        self.probes = 0

    def send(self, ctx) -> None:
        super().send(ctx)
        if ctx.msg_type >= 100 and isinstance(ctx.msg, self.P.wire_pb2.ServerForwardMessage) \
                and ctx.msg.payload.startswith(PROBE_PREFIX):
            self.probes += 1


class LossWorld(LossWorldBase, GatewayWorld):
    """19a: one soak's world in-process on a fixed clock (``StallClock``),
    through one package's modules ``P``: the cells world (``config``, with
    the scenario's CellBucket), a master owning GLOBAL and 4 recoverable
    server stubs (pits ``soak-spatial-<i>``) claiming the cells, the soak's
    ``EntitySim`` entities, ``clients`` stub clients each forwarding to the
    master at ``msg_rate`` until the soak stops them, the soak's pins. The
    schedule (``failover_schedule``/``balance_schedule``) runs between ticks;
    a kill makes the server's stub recoverable and closes it, as an aborted
    socket does, and a probe streams one frame a tick at an orphaned cell.
    Each tick advances the clock one GLOBAL budget, runs the recovery
    reaper's pass, the forwards and the probe, then every entity channel,
    GLOBAL (the controller, the balancer, the failover pass) and every
    spatial channel once. Records per tick the handovers, the tables, every
    outbound stream (the cell-authority messages digested apart), the
    failover, balancer and journal ledgers and events, the kill timeline,
    the frozen and deferred crossings, each cell's owner and
    ``ownerless_drops_total`` since the world was built. With ``K`` on the
    card, K1 and K2 are held against their plain versions on each kill
    tick's live tensors, the first tick after each re-host, and each
    migration's resolving tick."""

    def __init__(self, P, dev: torch.device, clock, schedule: str, p: dict, config: str,
                 K=None):
        self.P, self.dev, self.clock, self.p, self.K = P, dev, clock, p, K
        reset_gateway(P)
        self.drops0 = self.ownerless_total()  # the registry outlives the gateway's reset
        loss_pins(P, dev, p, balancer=schedule == "balance")
        P.message.init_message_map()
        P.channel.init_channels()
        P.sim_models.register_sim_types()
        P.controller.init_spatial_controller(config)
        ctl = self.ctl = P.controller.get_spatial_controller()
        self.eng = ctl.engine
        if P.port:
            check(self.eng.device.type == dev.type, f"the engine is on {self.eng.device}, not {dev}")
        self.conns: list = []
        self._servers()
        self.conns[0].pit = "soak-master"
        for i, server in enumerate(self.conns[1:]):
            server.pit = f"soak-spatial-{i}"
        self.servers = list(self.conns[1:])
        self.gch = P.channel.get_global_channel()
        self.sim = loss_sim(P, ctl, schedule, p)
        self.sim.create_entities()
        self.entity_channels = [P.channel.get_channel(e) for e in self.sim.entity_ids]
        self.clients = [self.conn(1000 + i, "CLIENT") for i in range(p["clients"])]
        self.prober = self.conn(900, "CLIENT")
        self.seq, self.next_send, self.sending = [0] * p["clients"], time.monotonic(), True
        self.probing = None
        self.probe_sent = 0
        self.timeline: list = []
        self.kills: list = []
        self.handovers, self.step_ms = [], []
        self.transfers = self.engine_ticks = 0
        self.kernel_checks: dict = {}
        self._due: list = []
        self._wrap()
        tick = self.eng.tick

        def counted_tick(*args, **kwargs):
            self.engine_ticks += 1
            return tick(*args, **kwargs)

        self.eng.tick = counted_tick
        self.t_start = time.monotonic()

    _wrap = TraceWorld._wrap

    def conn(self, conn_id: int, kind: str) -> GatewayConn:
        c = LossConn(self.P, conn_id, kind)
        self.P.connection._all_connections[conn_id] = c
        self.conns.append(c)
        return c

    # ---- what the schedules call ----

    def start(self) -> None:
        pass

    def kill(self, index: int, label: str) -> None:
        P, conn = self.P, self.servers[index]
        P.recovery.make_recoverable(conn)
        conn.close(unexpected=True)
        P.connection._all_connections.pop(conn.id, None)
        P.connection.close_epoch += 1  # the channels' prune scans key off it
        self.kills.append((len(self.obs), label, conn.id))
        self._due.append((len(self.obs), label))

    def probe(self, cell_id: int, until: float) -> None:
        self.probing = (cell_id, until, 0)

    def stop_sending(self) -> None:
        self.sending = False

    def frames_sent(self) -> int:
        return sum(self.seq)

    @property
    def probe_received(self) -> int:
        return sum(c.probes for c in self.servers)

    def ownerless_total(self) -> int:
        return int(sum(s.value for m in self.P.metrics.ownerless_drops.collect()
                       for s in m.samples if s.name.endswith("_total")))

    def ownerless_drops(self) -> int:
        """``ownerless_drops_total`` counted since the world was built."""
        return self.ownerless_total() - self.drops0

    # ---- the ticks ----

    def run(self, gen) -> dict:
        """Tick the world while ``gen`` sleeps; its report when it ends."""
        self.obs: list = []
        try:
            while True:
                wake = time.monotonic_ns() + round(next(gen) * 1e9)
                while time.monotonic_ns() < wake:
                    self.obs.append(self.tick(len(self.obs)))
        except StopIteration as done:
            return done.value

    def drive(self, t: int) -> None:
        P, p = self.P, self.p
        P.recovery.tick_connection_recovery_once()  # the reaper loop's pass
        handler = P.message.handle_client_to_server_user_message
        now = time.monotonic()
        while self.sending and self.next_send <= now:
            for i, client in enumerate(self.clients):
                msg = P.wire_pb2.ServerForwardMessage(
                    clientConnId=client.id, payload=np.array([i, self.seq[i]], "<u4").tobytes())
                self.gch.put_message(msg, handler, client,
                                     P.wire_pb2.MessagePack(channelId=0, msgType=100))
                self.seq[i] += 1
            self.next_send += 1.0 / p["msg_rate"]
        if self.probing is not None:
            cell_id, until, n = self.probing
            if now < until and n < p["probe_frames"]:
                msg = P.wire_pb2.ServerForwardMessage(
                    clientConnId=self.prober.id, payload=PROBE_PREFIX + np.array(
                        [n], "<u4").tobytes())
                P.channel.get_channel(cell_id).put_message(
                    msg, handler, self.prober,
                    P.wire_pb2.MessagePack(channelId=cell_id, msgType=100))
                self.probe_sent += 1
                self.probing = (cell_id, until, n + 1)
            else:
                self.probing = None

    def tick(self, t: int) -> dict:
        P, K, ctl = self.P, self.K, self.ctl
        plane, bal, journal = P.failover.plane, P.balancer.balancer, P.failover.journal
        self.clock.advance(self.p["global_tick_ms"] / 1000.0)
        self.drive(t)
        now = time.monotonic_ns()
        chans = P.channel.all_channels()
        cuda = self.dev.type == "cuda"
        crossings, transfers = len(self.handovers), self.transfers
        fires = P.chaos.chaos.fire_counts()
        n_failover, n_balancer = len(plane.events), len(bal.events)
        before = K.launch_counts() if K is not None else None
        sync(self.dev)
        with (Reads() if cuda else contextlib.nullcontext()) as reads:
            t0 = time.perf_counter()
            for ch in self.entity_channels:
                ch.tick_once(now)
            self.gch.tick_once(now)
            for cid in self.spatial:
                chans[cid].tick_once(now)
            t1 = time.perf_counter()
        tables = hashlib.sha256()
        for cid in self.spatial:
            tables.update(chans[cid].get_data_message().SerializeToString(deterministic=True))
        obs = dict(
            handovers=[r for rows in self.handovers[crossings:] for r in rows],
            deferred=sorted(ctl._deferred_crossings),
            tables=tables.hexdigest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns},
            cell_msgs={c.id: (c.cell_count, c.cell_digest.hexdigest()) for c in self.conns},
            elastic=elastic_state(ctl, P.partition.partition, bal, plane, journal),
            ledgers=dict(
                failover_events=[dict(e) for e in plane.events],
                balancer_events=fixed_clock_events(bal.events),
                in_flight=journal.in_flight_count(), kills=list(self.kills),
                owners=[(cid, chans[cid].get_owner().id if chans[cid].has_owner() else None)
                        for cid in self.spatial],
                drops=self.ownerless_drops(), probes=(self.probe_sent, self.probe_received)),
            fires={pt: n - fires.get(pt, 0) for pt, n in P.chaos.chaos.fire_counts().items()
                   if n != fires.get(pt, 0)},
            transfers=self.transfers - transfers if P.port else None,
            tick_ms=(t1 - t0) * 1e3, reads=reads.count if cuda else None)
        if K is not None:
            obs["launches"] = {n: c - before[n] for n, c in K.launch_counts().items()}
        for i, e in enumerate(plane.events[n_failover:], n_failover + 1):
            self._due.append((t + 1, f"rehost{i}"))
        for e in bal.events[n_balancer:]:
            self._due.append((t, f"{e['result']}{e['migration_id']}"))
        if K is not None and cuda:
            for due, label in [d for d in self._due if d[0] <= t]:
                self.kernel_checks[label] = uncounted(
                    K, lambda: elastic_live_kernels(K, self.eng, (4, 4)))
        self._due = [d for d in self._due if d[0] > t]
        return obs

    def close(self) -> None:
        self.P.chaos.disarm()
        reset_gateway(self.P)


def loss_lockstep_size(scratch: str, n_dev: Optional[int] = None, failover: Optional[dict] = None,
                       balance: Optional[dict] = None) -> dict:
    """19a's size: each schedule's params (the script's, at 19a's timeline
    ``FAILOVER_LOCKSTEP``/``BALANCE_LOCKSTEP``, then ``failover``/``balance``)
    and its cells config at MeshDevices = n_dev (default min(cards, 8)) with
    its scenario's CellBucket, written under ``scratch``."""
    if n_dev is None:
        n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
    out = dict(n_dev=n_dev)
    for name, kw in (("failover", failover), ("balance", balance)):
        sched = SCHEDULES[name]
        p = sched.params(**dict(sched.lockstep, **(kw or {})))
        d = os.path.join(scratch, name)
        os.makedirs(d, exist_ok=True)
        out[name] = dict(params=p, config=cells_config(n_dev, d, p["scenario"]["config_overrides"]))
    return out


def fixed_clock_events(events: list) -> list:
    """The balancer's events without ``duration_ms``: a migration's start
    time is taken from the host's clock (``CellMigration.t0``'s default
    factory was bound before the fixed clock was entered), so on a fixed
    clock its duration is no measurement and differs between legs."""
    return [{k: v for k, v in e.items() if k != "duration_ms"} for e in events]


def lockstep_part(r: dict, key: str):
    """A 19a report's ``key``, as both legs must hold it equal."""
    if key == "balancer" and key in r:
        return dict(r[key], events=fixed_clock_events(r[key]["events"]))
    return r.get(key)


def run_loss_schedule(P, dev: torch.device, schedule: str, p: dict, config: str,
                      K=None) -> tuple:
    """One schedule of 19a on one leg: (per-tick observations, the soak's
    report with the leg's launches, engine ticks, kernel checks and seconds)."""
    t_leg = time.perf_counter()
    with StallClock() as clock:
        world = LossWorld(P, dev, clock, schedule, p, config, K)
        if K is not None:
            K.reset_launch_counts()
        report = world.run(SCHEDULES[schedule].run(world, p))
        obs = world.obs
        report.update(
            launches=K.launch_counts() if K is not None else None,
            engine_ticks=world.engine_ticks, kernels=dict(world.kernel_checks),
            step_ms=list(world.step_ms),
            n_shards=world.eng._mesh.size if getattr(world.eng, "_mesh", None) else 1)
        world.close()
        del world
    report["secs"] = time.perf_counter() - t_leg
    return obs, report


def run_loss_lockstep(P, dev: torch.device, size: dict, K=None) -> tuple:
    """19a on one leg: ({schedule: observations}, {schedule: report})."""
    obs, reports = {}, {}
    for schedule in ("failover", "balance"):
        obs[schedule], reports[schedule] = run_loss_schedule(
            P, dev, schedule, size[schedule]["params"], size[schedule]["config"], K)
    return obs, reports


def loss_checks(schedule: str, r: dict, p: dict) -> list:
    """The script's invariants of a report, under its names."""
    return (failover_soak_checks if schedule == "failover" else balance_soak_checks)(r, p)


class LiveLoss(LossWorldBase):
    """19b/19c's world: one package's gateway live on this asyncio loop, as
    scripts/chaos_soak.py boots it (``soak_boot_world``'s master and 4
    spatial servers over TCP, ``soak_client_loop`` clients, the soak's
    entity sim); a kill aborts server ``soak-spatial-<i>``'s socket, a probe
    streams forwards at an orphaned cell over a client socket of its own
    (the script's _probe_orphan_cell), and a poller records the timeline
    every 250 ms."""

    def __init__(self, P, ctl, p: dict, host: str, client_port: int, stats, stop, send_stop,
                 tasks: list):
        self.P, self.ctl, self.p, self.host, self.client_port = P, ctl, p, host, client_port
        self.stats, self.stop, self.send_stop, self.tasks = stats, stop, send_stop, tasks
        self.probe_sent = self.probe_received = 0
        self.timeline: list = []
        self.notes: list = []
        self.socks: list = []
        self.t_start = time.monotonic()

    def on_server_pack(self, mp) -> None:
        """The failover soak's _probe_drain: count the probe frames a spatial
        server is forwarded."""
        if mp.msgType < 100:
            return
        sfm = self.P.wire_pb2.ServerForwardMessage()
        try:
            sfm.ParseFromString(mp.msgBody)
        except Exception:
            return
        if sfm.payload.startswith(PROBE_PREFIX):
            self.probe_received += 1

    def start(self) -> None:
        import asyncio

        self.tasks.append(asyncio.ensure_future(self._poller()))

    async def _poller(self) -> None:
        import asyncio

        plane, bal = self.P.failover.plane, self.P.balancer.balancer
        while not self.stop.is_set():
            loads = self.server_entity_loads()
            mig = bal.migration_in_flight()
            self.timeline.append(dict(
                t=round(time.monotonic() - self.t_start, 2),
                cells_owned=sum(1 for ch in self.spatial_channels().values() if ch.has_owner()),
                servers_lost=plane.ledger["servers_lost"],
                cells_rehosted=plane.ledger["cells_rehosted"],
                server_entities=dict(sorted(loads.items())),
                entity_imbalance=round(entity_imbalance(loads), 3),
                committed=bal.ledger.get("committed", 0), aborted=bal.ledger.get("aborted", 0),
                in_flight=mig.cell_id if mig is not None else None))
            await asyncio.sleep(0.25)

    def kill(self, index: int, label: str) -> None:
        self.socks[1 + index][2].transport.abort()

    def probe(self, cell_id: int, until: float) -> None:
        import asyncio

        self.tasks.append(asyncio.ensure_future(self._probe(cell_id, until)))

    async def _probe(self, cell_id: int, until: float) -> None:
        import asyncio

        P, n = self.P, 0
        frames = self.p["probe_frames"]
        while time.monotonic() < until and n < frames:
            writer = None
            try:
                reader, writer = await asyncio.open_connection(self.host, self.client_port)
                await soak_auth(P, reader, writer, f"orphan-prober-{cell_id}")
                reader_task = asyncio.ensure_future(
                    soak_read_frames(P, reader, lambda mp: None, self.stop))
                while time.monotonic() < until and n < frames:
                    writer.write(soak_frame(P, 100, PROBE_PREFIX + np.array([n], "<u4").tobytes(),
                                            channel_id=cell_id))
                    await writer.drain()
                    self.probe_sent += 1
                    n += 1
                    await asyncio.sleep(0.02)
                reader_task.cancel()
            except (ConnectionError, OSError, TimeoutError) as e:
                self.notes.append(f"orphan prober retry: {e!r}")
                await asyncio.sleep(0.05)
            finally:
                if writer is not None:
                    writer.close()

    def stop_sending(self) -> None:
        self.send_stop.set()

    def frames_sent(self) -> int:
        return sum(self.stats.client_sent.values())


async def loss_live(P, dev: torch.device, schedule: str, p: dict, scratch: str, n_dev: int,
                    K=None) -> dict:
    """19b (``schedule`` "failover") or 19c ("balance"): the script's soak
    through one package's gateway, in-process on this asyncio loop: TCP
    listeners on loopback, the flush pump and the reaper, the soak's pins,
    the cells world at MeshDevices ``n_dev`` with the scenario's CellBucket,
    the engine on ``dev``, the master and 4 recoverable spatial servers,
    ``clients`` clients streaming forwards at ``msg_rate``, the soak's
    entities; then the schedule, live. Returns the soak's report, plus the
    engine's device, its ticks and (with ``K``) the kernels' launches."""
    import asyncio

    reset_gateway(P)
    loss_pins(P, dev, p, balancer=schedule == "balance")
    P.sim_models.register_sim_types()
    P.connection.init_connections(SERVER_FSM, CLIENT_FSM)
    P.channel.init_channels()
    P.ddos.init_anti_ddos()
    P.controller.init_spatial_controller(
        cells_config(n_dev, scratch, p["scenario"]["config_overrides"]))
    ctl = P.controller.get_spatial_controller()
    engine_ticks = engine_tick_counter(ctl.engine)
    before = K.launch_counts() if K is not None else None
    host = "127.0.0.1"
    stop, send_stop = asyncio.Event(), asyncio.Event()
    server_srv, client_srv, tasks = await live_listeners(P, host)
    stats = SoakStats()
    w = LiveLoss(P, ctl, p, host, client_srv.sockets[0].getsockname()[1], stats, stop,
                 send_stop, tasks)
    try:
        w.socks = await soak_boot_world(P, host, server_srv.sockets[0].getsockname()[1], stats,
                                        stop, on_server_pack=w.on_server_pack)
        tasks += [task for task, _, _ in w.socks]
        w.sim = loss_sim(P, ctl, schedule, p)
        w.sim.create_entities()
        tasks += [asyncio.ensure_future(soak_client_loop(
            P, i, host, w.client_port, p["msg_rate"], stats, stop, send_stop))
            for i in range(p["clients"])]
        gen = SCHEDULES[schedule].run(w, p)
        try:
            while True:
                await asyncio.sleep(next(gen))
        except StopIteration as done:
            report = done.value
        if w.notes:
            report["notes"] = list(report.get("notes") or []) + w.notes
        report.update(engine=str(ctl.engine.device) if P.port else None,
                      engine_ticks=engine_ticks[0],
                      launches=({n: c - before[n] for n, c in K.launch_counts().items()}
                                if K is not None else None))
        return report
    finally:
        stop.set()
        send_stop.set()
        P.chaos.disarm()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for _, _, writer in w.socks:
            writer.close()
        server_srv.close()
        client_srv.close()
        reset_gateway(P)


def artifact_keys_missing(report: dict) -> list:
    """The keys scripts/check_artifacts.py requires of this soak's artifact
    that the report lacks."""
    return sorted(ARTIFACT_KEYS[report["kind"]] - set(report))


def loss_timeline(schedule: str, r: dict) -> str:
    """The kills and re-hosts (failover), or the migrations and the kill's
    abort (balance), of a report, as one line's words."""
    if schedule == "failover":
        kills = "; ".join(
            f"{k['label']} ({k['pit']}, conn {k['conn_id']}, {len(k['owned_cells'])} cells) at "
            f"{k['t']:g} s, re-hosted in {k['rehosted_in_s']} s" for k in r["kills"])
        rehosts = "; ".join(
            f"{e['pit']}: {len(e['rehosted'])}/{len(e['orphan_cells'])} cells to "
            f"{sorted(set(e['rehosted'].values()))}, {e['entities_repointed']} entity channels "
            f"re-pointed, {e['handovers_aborted']} handovers aborted"
            for e in r["failover"]["events"])
        return f"kills: {kills}; re-hosts: {rehosts}"
    migs = ", ".join(f"#{e['migration_id']} cell {e['cell']} {e['from']}->{e['to']} "
                     f"{e['result']} (epoch {e['epoch']}, ticks {e['planned_tick']}-"
                     f"{e['resolved_tick']})" for e in r["balancer"]["events"])
    return (f"migrations: {migs}; the kill: {r['kill']}; failover events "
            f"{[(e['pit'], len(e['rehosted'])) for e in r['failover']['events']]}; steady loads "
            f"{r['steady_state']['server_entities']} (imbalance "
            f"{r['steady_state']['entity_imbalance']})")


def loss_ledgers(schedule: str, r: dict) -> str:
    """A report's ledgers, as one line's words."""
    st = r["stats"]
    if schedule == "failover":
        return (f"failover ledger {r['failover']['ledger']}; journal {r['journal']['counts']} "
                f"(in flight {r['journal']['in_flight']}); probes sent {st['probe_frames_sent']}, "
                f"forwarded {st['probe_frames_forwarded']}, ownerless_drops_total "
                f"{st['ownerless_drops']}; handovers {st['handovers_total']} "
                f"({st['handovers_after_failover']} after the last re-host); client frames "
                f"{st['client_frames_sent']}")
    return (f"balancer ledger {r['balancer']['ledger']} (= balancer_migrations_total); failover "
            f"ledger {r['failover']['ledger']}; journal {r['journal']['counts']} (in flight "
            f"{r['journal']['in_flight']}); handovers {st['handovers_total']}; client frames "
            f"{st['client_frames_sent']}")


def loss_names(schedule: str, p: dict) -> tuple:
    """The invariants the script checks at ``p``, in its order."""
    if schedule == "failover":
        return FAILOVER_INVARIANTS
    if p["kill_mid_migration"]:
        return BALANCE_INVARIANTS
    return tuple(n for n in BALANCE_INVARIANTS
                 if n not in ("kill_mid_migration_landed",
                              "crash_mid_migration_aborts_to_old_owner"))


def report_checks(label: str, schedule: str, r: dict, p: dict) -> None:
    """Fail unless every invariant of the script holds on ``r``, all under
    their names."""
    checks = r["invariants"]["checks"]
    for c in checks:
        check(c["ok"], f"{label}: {c['name']}: {c['detail']}")
    names = tuple(c["name"] for c in checks)
    check(names == loss_names(schedule, p), f"{label}: the invariants checked were {names}")


def phase_loss_lockstep(K, dev, cpu_leg: "CpuLeg") -> tuple:
    """19a: both schedules through ``LossWorld`` on the card against their
    lockstep CPU leg at the same size (``cpu_leg.size``) in ``cpu_leg``'s
    child, tick for tick, each leg held to the scripts' invariants. Returns
    ({schedule path: launches}, the kernels' entries on the named ticks)."""
    P = gateway_modules()
    size = cpu_leg.size
    n_dev = size["n_dev"]
    t_phase = time.perf_counter()
    try:
        card, rc = run_loss_lockstep(P, dev, size, K)
        cpu, rp = cpu_leg.result()
    finally:
        cpu_leg.close()
    launches, entries = {}, {}
    for schedule in ("failover", "balance"):
        label, p = f"19a {schedule}", size[schedule]["params"]
        c, g, r = card[schedule], cpu[schedule], rc[schedule]
        check(len(c) == len(g), f"{label}: {len(c)} card and {len(g)} cpu ticks")
        for t in range(len(c)):
            where = first_gateway_diff(c[t], g[t])
            check(where is None, f"{label} tick {t}: cuda and cpu differ: {where}")
        for key in ("kills", "failover", "balancer", "kill", "journal", "books", "steady_state"):
            check(lockstep_part(r, key) == lockstep_part(rp[schedule], key),
                  f"{label}: the legs' {key} differ: {str(r.get(key))[:200]} vs "
                  f"{str(rp[schedule].get(key))[:200]}")
        for leg, obs, rr in (("cuda", c, r), ("cpu", g, rp[schedule])):
            report_checks(f"{label} {leg}", schedule, rr, p)
            check({o["transfers"] for o in obs} == {2},
                  f"{label} {leg}: engine transfers a tick {sorted({o['transfers'] for o in obs})}")
        n = r["n_shards"]
        for t, o in enumerate(c):
            check(o["launches"] == {name: n for name in o["launches"]},
                  f"{label} tick {t}: launches {o['launches']}, not {n} each (one per shard)")
            check(o["reads"] == 2, f"{label} tick {t}: {o['reads']} device reads, not 2 (the "
                                   f"consume blob and the query plane's changed rows)")
        check(r["launches"] == {name: n * r["engine_ticks"] for name in r["launches"]}
              and r["engine_ticks"] == len(c),
              f"{label}: launches {r['launches']} in {r['engine_ticks']} engine ticks, "
              f"{len(c)} GLOBAL ticks")
        want = ({lbl for _, lbl, _ in c[-1]["ledgers"]["kills"]}
                | {f"rehost{i}" for i in range(1, len(r["failover"]["events"]) + 1)}
                | {f"{e['result']}{e['migration_id']}"
                   for e in r.get("balancer", {}).get("events", [])})
        check(set(r["kernels"]) == want,
              f"{label}: K1/K2 held on {sorted(r['kernels'])}, not {sorted(want)}")
        launches[f"{schedule}_lockstep"] = r["launches"]
        ticks = len(c)
        print(f"{label} lockstep: {ticks} GLOBAL ticks ({r['duration_s']:g} s of the fixed "
              f"clock) of config/spatial_tpu_cells_2x2.json at MeshDevices {n_dev} with "
              f"CellBucket {p['scenario']['config_overrides']['CellBucket']} "
              f"({p['entity_capacity']} slots, {p['query_capacity']} query rows), "
              f"{p['entities']} entities, {p['clients']} clients at {p['msg_rate']:g} msg/s, "
              f"the script's pins and weather (fires {r['chaos']}); every invariant of the "
              f"script held on both legs ({len(r['invariants']['checks'])}); cuda equals the "
              f"CPU leg on every tick (handovers, tables, every outbound stream and the "
              f"cell-authority messages apart, the failover and balancer ledgers and events, the "
              f"kill timeline, the journal, the frozen and deferred crossings, the cells' owners, "
              f"ownerless_drops_total); 2 device reads and 2 engine transfers a tick; "
              f"{loss_timeline(schedule, r)}; {loss_ledgers(schedule, r)}; GLOBAL tick p99 "
              f"{r['stats']['global_tick_p99_s']:.4f} s and tpu_spatial_step_seconds p99 "
              f"{r['stats']['device_step_p99_s']:.4f} s on the fixed clock (its stalls), on "
              f"the host's clock the tick {tick_stats([o['tick_ms'] for o in c[1:]])} and "
              f"the device step {tick_stats(r['step_ms'][1:])} on cuda, the tick "
              f"{tick_stats([o['tick_ms'] for o in g[1:]])} on the cpu; launches "
              f"{r['launches']} in {r['engine_ticks']} engine ticks; card leg "
              f"{r['secs']:.1f} s, cpu leg {rp[schedule]['secs']:.1f} s")
        for case, ks in r["kernels"].items():
            for name, k in ks.items():
                entries.setdefault(name, {})[f"19a_{schedule}_{case}"] = k
                print(f"{label} {name} on the {case} tick's live tensors ({k['shape']}): exact; "
                      f"alone {k['ms']:.4f} ms (events, bare launches), plain "
                      f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.6f} ms ({k['bound_by']})")
    print(f"19a: phase {time.perf_counter() - t_phase:.1f} s (cpu leg "
          f"{rp['failover']['secs'] + rp['balance']['secs']:.1f} s in a --cpu-leg child)")
    return launches, entries


def phase_loss_live(K, dev, n_dev: int, schedule: str, p: dict) -> dict:
    """19b (failover) / 19c (balance): ``loss_live`` on the card, held to the
    script's invariants under their names, to the keys check_artifacts
    requires of its artifact, and to K1/K2 once per shard on every engine
    tick."""
    import asyncio
    import shutil
    import tempfile

    label = "19b" if schedule == "failover" else "19c"
    P = gateway_modules()
    scratch = tempfile.mkdtemp(prefix=f"{schedule}-live-")
    t_phase = time.perf_counter()
    try:
        r = asyncio.run(loss_live(P, dev, schedule, p, scratch, n_dev, K))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    report_checks(label, schedule, r, p)
    check(artifact_keys_missing(r) == [], f"{label}: the artifact lacks "
                                          f"{artifact_keys_missing(r)}")
    phase_live_launches(r, n_dev, label)
    st = r["stats"]
    print(f"{label} {schedule} soak live: scripts/{schedule}_soak.py's run through the port's "
          f"gateway at its defaults, timeline not cut ({r['phases']}), {p['clients']} clients at "
          f"{p['msg_rate']:g} msg/s, {p['entities']} entities, MeshDevices {n_dev} with "
          f"CellBucket {p['scenario']['config_overrides']['CellBucket']}, "
          f"{p['entity_capacity']} slots / {p['query_capacity']} query rows, the engine on "
          f"{r['engine']}; every invariant of the script held "
          f"({len(r['invariants']['checks'])}) and check_artifacts' keys; chaos fires "
          f"{r['chaos']}; {loss_timeline(schedule, r)}; {loss_ledgers(schedule, r)}; "
          f"GLOBAL tick p99 "
          f"{st['global_tick_p99_s']:.4f} s, tpu_spatial_step_seconds p99 "
          f"{st['device_step_p99_s']:.4f} s; launches {r['launches']} in {r['engine_ticks']} "
          f"engine ticks; soak {r['duration_s']} s; phase {time.perf_counter() - t_phase:.1f} s")
    return r


def phase_failover_balance(K, dev, cpu_leg: "CpuLeg") -> tuple:
    """Phase 19: 19a (its CPU leg in ``cpu_leg``'s child, ``CpuLeg("19a")``),
    then 19b and 19c at the scripts' defaults, on the cells world at
    MeshDevices = min(cards, 8) and the gateway's tables. Returns ({path:
    launches}, {kernel: {case: entry}})."""
    n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
    t_phase = time.perf_counter()
    launches, entries = phase_loss_lockstep(K, dev, cpu_leg)
    failover = phase_loss_live(K, dev, n_dev, "failover", failover_params(**GATEWAY_CAPACITIES))
    balance = phase_loss_live(K, dev, n_dev, "balance", balance_params(**GATEWAY_CAPACITIES))
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return (dict(launches, failover_live=failover["launches"], balance_live=balance["launches"]),
            entries)


def main_failover_balance() -> int:
    """Phases 1-3 and then phase 19 alone: ``python3 chip_smoke.py
    --failover-balance``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    leg = None
    try:
        leg = CpuLeg("19a", failover=GATEWAY_CAPACITIES, balance=GATEWAY_CAPACITIES)
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        phase_failover_balance(K, dev, leg)
    except PhaseFailed as e:
        report_failure(e)
        return 1
    finally:
        if leg is not None:
            leg.close()
    print(f"chip_smoke --failover-balance: every phase passed in "
          f"{time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


# ---- phase 20: __graft_entry__.py's entry points ----------------------------

# 20b: entry()'s example at the sidecar's scale (phase 4's world).
GRAFT_SIDECAR = dict(n=100_000, q=4_096, s=65_536, cols=15, rows=15)
GRAFT_SHARDS = 8  # __graft_entry__.dryrun_multichip(8), the multi-chip check of README.md


def graft_cards(n: int) -> Optional[list]:
    """20c's mesh devices: None (``mesh_devices``' ``n`` distinct cards) when
    ``n`` cards are present, else the cards present repeated in turn to
    ``n`` shards."""
    present = torch.cuda.device_count()
    return None if present >= n else [torch.device("cuda", i % present) for i in range(n)]


def dryrun_launches(n: int) -> dict:
    """The kernels' launches of ``dryrun_multichip(n)``: each of its 3 ticks
    runs the single-device engine (K1, K2), the entities mesh (K1 per
    shard, K2 once on the replica), for an even ``n`` the 2D mesh (the
    same) and the cells serving mesh (K1 and K2 per shard); the
    cell-sharded step then runs K1 once per shard."""
    from channeld_tpu_torch.graft_entry import DRY_RUN_TICKS

    meshes_k1 = (2 if n % 2 == 0 else 1) * n + n
    meshes_k2 = (2 if n % 2 == 0 else 1) + n
    ticks = len(DRY_RUN_TICKS)
    return {"assign_count": ticks * (1 + meshes_k1) + n, "aoi": ticks * (1 + meshes_k2)}


def phase_graft_step(K, dev, label: str, sizes: dict) -> tuple:
    """20a / 20b: ``entry(**sizes)``'s ``fn`` on ``dev`` against the same call
    on the CPU, every output equal exactly, K1 and K2 launched once each
    from 0 and held against their plain versions on the step's tensors.
    Returns (launches, {kernel: entry})."""
    from channeld_tpu_torch import graft_entry as g
    from channeld_tpu_torch.ops.spatial_ops import QuerySet

    t_phase = time.perf_counter()
    fn, args = g.entry(device=dev, **sizes)
    cpu_fn, cpu_args = g.entry(device="cpu", **sizes)
    for i, (a, b) in enumerate(zip(args[:-1], cpu_args[:-1])):
        check(a.device.type == dev.type and torch.equal(a.cpu(), b),
              f"{label}: example argument {i} differs between the card and the CPU")
    K.reset_launch_counts()
    sync(dev)
    out = fn(*args)
    sync(dev)
    launches = K.launch_counts()
    check(launches == {"assign_count": 1, "aoi": 1},
          f"{label}: launches {launches}, not one of each kernel")
    t0 = time.perf_counter()
    want = cpu_fn(*cpu_args)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    check(set(out) == set(want), f"{label}: keys {sorted(out)} vs {sorted(want)}")
    for key in want:
        a, b = out[key], want[key]
        check(a.device.type == dev.type and a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a.cpu(), b), f"{label}: {key} differs between the card and the CPU")
    grid = g._example_inputs(device="cpu", **sizes)[0]
    kernels = soak_live_kernels(K, grid, args[0], args[2], QuerySet(*args[3:8]))
    step_ms = uncounted(K, lambda: median_ms(lambda: fn(*args), reps=20, warmup=3))
    # The step's device time alone: 20 steps queued behind a sleep (each
    # is ~30 launches; CUDA's queue of pending launches holds ~1K).
    device_ms = uncounted(K, lambda: queued_ms(lambda: fn(*args), reps=20))
    n, q, s = args[0].shape[0], args[3].shape[0], args[8].shape[0]
    print(f"{label} entry(): spatial_step on {n} entities, {q} sphere queries, {s} "
          f"subscriptions, {grid.cols}x{grid.rows} cells, {g.MAX_HANDOVERS} handover rows at "
          f"now_ms {args[-1]}: every output ({len(want)}) equal to the CPU run exactly; "
          f"launches {launches}; {int(want['handover_count'])} handovers, "
          f"{int(want['cell_counts'].sum())} placed, {int(want['interest'].sum())} interested "
          f"pairs, {int(want['due'].sum())} due; step {step_ms:.4f} ms on the card (events, "
          f"median of 20), {device_ms:.4f} ms of it the device's (20 steps queued), "
          f"{cpu_ms:.1f} ms on the CPU (host clock, one call); "
          + "; ".join(f"{name} on the step's tensors ({k['shape']}): exact; alone "
                      f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound "
                      f"{k['bound_ms']:.6f} ms ({k['bound_by']})" for name, k in kernels.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return launches, {name: dict(k, step_ms=step_ms, step_device_ms=device_ms)
                      for name, k in kernels.items()}


def phase_graft_dryrun(K, n: int = GRAFT_SHARDS, devices=None) -> dict:
    """20c: ``dryrun_multichip(n)`` on the card (``devices``, by default
    ``graft_cards(n)``) passes its own checks, launches the kernels as its
    meshes do (``dryrun_launches``) and equals ``dryrun_multichip(n,
    device="cpu")`` on every tick of every sharding and on the cell-sharded
    plane. Returns the launches."""
    from channeld_tpu_torch import graft_entry as g

    t_phase = time.perf_counter()
    devices = graft_cards(n) if devices is None else devices
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        card = g.dryrun_multichip(n, devices=devices)
        card_s = time.perf_counter() - t0
        launches = K.launch_counts()
        t0 = time.perf_counter()
        cpu = g.dryrun_multichip(n, device="cpu")
        cpu_s = time.perf_counter() - t0
    except AssertionError as e:
        raise PhaseFailed(f"20c: dryrun_multichip({n}): {e}") from e
    want = dryrun_launches(n)
    check(launches == want, f"20c: launches {launches}, not {want}")
    labels = [label for label, _ in card["meshes"]]
    check(labels == [label for label, _ in cpu["meshes"]],
          f"20c: shardings {labels} vs {[label for label, _ in cpu['meshes']]}")
    runs = [("single", card["single"], cpu["single"])] + [
        (label, ticks, ref) for (label, ticks), (_, ref) in zip(card["meshes"], cpu["meshes"])]
    for label, got, ref in runs:
        check(len(got) == len(ref), f"20c {label}: {len(got)} card and {len(ref)} cpu ticks")
        for t, (a, b) in enumerate(zip(got, ref)):
            where = g.first_difference(a, b)
            check(where is None, f"20c {label} tick {t}: {where} differs from the CPU run")
    for key in ("counts", "dense"):
        check(np.array_equal(card["cells_plane"][key], cpu["cells_plane"][key]),
              f"20c: the cell-sharded plane's {key} differ from the CPU run")
    used = devices or [torch.device("cuda", i) for i in range(n)]
    print(f"20c dryrun_multichip({n}) on {len(set(used))} card(s) as {n} shards "
          f"({', '.join(str(d) for d in used)}): its own checks held; every tick's decisions "
          f"(cell counts, handovers, the interest of queries 1 and 3, due) of the single "
          f"device and the {labels} shardings and the "
          f"cell-sharded plane's counts equal to dryrun_multichip({n}, device='cpu'); "
          f"{card['handovers']} handovers; launches {launches}; card run {card_s:.1f} s, "
          f"cpu run {cpu_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_graft_entry(K, dev) -> tuple:
    """Phase 20: 20a, 20b and 20c. Returns ({path: launches}, {kernel:
    {case: entry}})."""
    t_phase = time.perf_counter()
    launches, cases_a = phase_graft_step(K, dev, "20a", {})
    _, cases_b = phase_graft_step(K, dev, "20b", GRAFT_SIDECAR)
    entries = {name: {"20a": cases_a[name], "20b": cases_b[name]} for name in cases_a}
    dry = phase_graft_dryrun(K)
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return {"graft_entry": launches, "dryrun_multichip": dry}, entries


def main_graft_entry() -> int:
    """Phases 1-3 and then phase 20 alone: ``python3 chip_smoke.py
    --graft-entry``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        phase_graft_entry(K, dev)
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(f"chip_smoke --graft-entry: every phase passed in "
          f"{time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_edge() -> int:
    """Phases 1-3, then phase 18: ``python3 chip_smoke.py --edge``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        phase_edge_live(K)
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(f"chip_smoke --edge: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0

def main_soaks(agents: int, entities: int) -> int:
    """Phase 12 alone (after the device and build phases):
    ``python3 chip_smoke.py --soaks 1000 4096``."""
    from channeld_tpu_torch.ops import cuda_kernels as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_soaks(K, dev, CpuLeg("12b", entities=entities), agents)
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_trace_obs() -> int:
    """Phases 1-3 and then phase 13 alone: ``python3 chip_smoke.py --trace-obs``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        phase_trace_obs(K, dev)
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(f"chip_smoke --trace-obs: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_chaos_overload() -> int:
    """Phases 1-3 and then phase 14 alone: ``python3 chip_smoke.py --chaos-overload``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        phase_chaos_overload(K, dev, CpuLeg("14a", **GATEWAY_CAPACITIES))
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(f"chip_smoke --chaos-overload: every phase passed in "
          f"{time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_fleet() -> int:
    """Phases 1-3 and then phase 15 alone: ``python3 chip_smoke.py --fleet``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        phase_fleet(K, dev)
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(f"chip_smoke --fleet: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_crash() -> int:
    """Phases 1-3 and then phase 16 alone: ``python3 chip_smoke.py --crash``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        phase_crash(K, dev, CpuLeg("16a"))
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(f"chip_smoke --crash: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_fleet_live() -> int:
    """Phases 1-3, the trace and obs soaks' phase 1 (13b and 13d), then phase
    17: ``python3 chip_smoke.py --fleet-live``. The scripts run their phase 2
    after their phase 1 in one process, and two of 17's checks read what
    phase 1 leaves: 17a's stage check 13b's stages, 17b's label-set count
    the ones a's registry holds."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_kernels(K, ops, dev)
        n_dev = min(torch.cuda.device_count(), MESH_SHARDS)
        live = phase_trace_live(K, dev, n_dev, trace_params())
        phase_obs_live(K, dev, n_dev, obs_params())
        phase_fleet_live(K, dict(stages=live["stages"], batched_ingest=live["batched_ingest"]))
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(f"chip_smoke --fleet-live: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_gateway(entities: int, ticks: int) -> int:
    """Phase 6a alone at another size (after the device and build
    phases): ``python3 chip_smoke.py --gateway 50000 30``."""
    from channeld_tpu_torch.ops import cuda_kernels as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_gateway_lockstep(K, dev, CpuLeg("6a", entities=entities, ticks=ticks))
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_mesh() -> int:
    """Phase 7 alone (after the device and build phases):
    ``python3 chip_smoke.py --mesh``."""
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import engine as engine_mod
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_mesh_steps(K, ops)
        phase_mesh_engine(K, engine_mod, ops)
        phase_mesh_gateway(K)
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_engine_adapter(objects: int, ticks: int) -> int:
    """Phase 8a alone at another size (after the device and build
    phases): ``python3 chip_smoke.py --engine-adapter 10000 12``."""
    from channeld_tpu_torch.ops import cuda_kernels as K

    torch.cuda.set_device(torch.device("cuda", 0))
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_engine_adapter(K, engine_size(objects, ticks))
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_recovery(entities: int, ticks: int) -> int:
    """Phase 10a alone at another size (after the device and build
    phases): ``python3 chip_smoke.py --recovery 10000 30``."""
    from channeld_tpu_torch.ops import cuda_kernels as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_recovery_lockstep(K, dev, CpuLeg("10a", entities=entities, ticks=ticks))
    except PhaseFailed as e:
        report_failure(e)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main_elastic(entities: int, ticks: int) -> int:
    """Phases 11a and 11b alone (after the device and build phases), 11b
    at half the entities: ``python3 chip_smoke.py --elastic 1500 120``."""
    from channeld_tpu_torch.ops import cuda_kernels as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    legs = []
    try:
        name, _ = phase_device()
        phase_build(K)
        legs = [CpuLeg("11a", entities=entities, ticks=ticks),
                CpuLeg("11b", entities=entities // 2, ticks=ticks)]
        phase_elastic_lockstep(K, dev, legs[0])
        phase_elastic_mesh(K, legs[1])
    except PhaseFailed as e:
        report_failure(e)
        return 1
    finally:
        for leg in legs:
            leg.close()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--cpu-leg"]:
        # A lockstep phase's CPU leg, beside the parent's card leg.
        return cpu_leg_child(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--sticky-child"]:
        return sticky_child()
    if sys.argv[1:2] == ["--recovery"]:
        return main_recovery(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--gateway"]:
        return main_gateway(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--mesh"]:
        return main_mesh()
    if sys.argv[1:2] == ["--engine-adapter"]:
        return main_engine_adapter(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--elastic"]:
        return main_elastic(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--soaks"]:
        return main_soaks(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--trace-obs"]:
        return main_trace_obs()
    if sys.argv[1:2] == ["--chaos-overload"]:
        return main_chaos_overload()
    if sys.argv[1:2] == ["--fleet"]:
        return main_fleet()
    if sys.argv[1:2] == ["--crash"]:
        return main_crash()
    if sys.argv[1:2] == ["--fleet-live"]:
        return main_fleet_live()
    if sys.argv[1:2] == ["--edge"]:
        return main_edge()
    if sys.argv[1:2] == ["--failover-balance"]:
        return main_failover_balance()
    if sys.argv[1:2] == ["--graft-entry"]:
        return main_graft_entry()
    if sys.argv[1:2] == ["--sim-child"]:
        return sim_child(sys.argv[2], *map(int, sys.argv[3:5]), *sys.argv[5:6])
    t_run = time.perf_counter()
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import engine as engine_mod
    from channeld_tpu_torch.ops import service
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    laps = PhaseLaps()
    legs: dict = {}
    try:
        name, _ = phase_device()
        phase_build(K)
        entries = phase_kernels(K, ops, dev)
        laps("1-3")
        # Each lockstep phase's CPU leg runs in a child started a phase or
        # more early, beside phases whose host is mostly idle: 6a's beside
        # phases 4-5, 10a's beside 8-9, 11a's and 11b's beside 10, 12b's
        # beside 12a, 14a's beside 13, 16a's beside 15, 19a's beside 16-18.
        legs["gateway"] = CpuLeg("6a")
        launches = phase_main_path(K, service, dev)
        laps("4")
        sim_launches, sim_entries = phase_sim_world(K, engine_mod, ops, dev)
        laps("5")
        gateway_launches = phase_gateway_lockstep(K, dev, legs["gateway"])
        phase_gateway_live()
        phase_gateway_threads(K, engine_mod, ops, dev)
        laps("6")
        mesh_launches, mesh_entries = phase_mesh_steps(K, ops)
        mesh_engine_launches = phase_mesh_engine(K, engine_mod, ops)
        mesh_gateway_launches = phase_mesh_gateway(K)
        laps("7")
        legs["recovery"] = CpuLeg("10a")
        engine_launches = phase_engine_adapter(K, engine_size())
        unreal_launches = phase_unreal(K)
        phase_replay_live()
        laps("8")
        phase_native_codec()
        phase_sidecar(service, dev)
        laps("9")
        legs.update(elastic=CpuLeg("11a"), elastic_mesh=CpuLeg("11b"))
        recovery_launches = phase_recovery_lockstep(K, dev, legs["recovery"])
        phase_recovery_wedge(K, dev)
        phase_recovery_sticky()
        phase_recovery_live()
        laps("10")
        elastic_launches, elastic_entries = phase_elastic_lockstep(K, dev, legs["elastic"])
        elastic_mesh_launches, elastic_mesh_entries = phase_elastic_mesh(K, legs["elastic_mesh"])
        phase_elastic_live()
        laps("11")
        legs["sensor"] = CpuLeg("12b")
        soak_launches, soak_entries = phase_soaks(K, dev, legs["sensor"])
        laps("12")
        legs["overload"] = CpuLeg("14a", **GATEWAY_CAPACITIES)
        trace_obs_launches, trace_obs_entries, trace_live = phase_trace_obs(K, dev)
        laps("13")
        chaos_launches, chaos_entries = phase_chaos_overload(K, dev, legs["overload"])
        laps("14")
        legs["crash"] = CpuLeg("16a")
        fleet_launches, fleet_entries = phase_fleet(K, dev)
        laps("15")
        legs["loss"] = CpuLeg("19a", failover=GATEWAY_CAPACITIES, balance=GATEWAY_CAPACITIES)
        crash_launches, crash_entries = phase_crash(K, dev, legs["crash"])
        laps("16")
        fleet_live_launches = phase_fleet_live(K, trace_live)
        laps("17")
        edge_launches = phase_edge_live(K)
        laps("18")
        loss_launches, loss_entries = phase_failover_balance(K, dev, legs["loss"])
        laps("19")
        graft_launches, graft_entries = phase_graft_entry(K, dev)
        laps("20")
    except PhaseFailed as e:
        report_failure(e)
        return 1
    finally:
        for leg in legs.values():
            leg.close()
    print(f"chip_smoke phase wall times: {laps.summary()}")
    kernels = []
    for spec in K.KERNEL_SPECS:
        kernels.append(dict(
            name=spec.name, route="cuda",
            source=f"channeld_tpu_torch/ops/csrc/{spec.source}",
            replaces=spec.replaces, launches=launches[spec.name],
            launches_by_path={"sidecar": launches[spec.name],
                              "sim_world": sim_launches[spec.name],
                              "gateway": gateway_launches[spec.name],
                              "mesh_steps": mesh_launches[spec.name],
                              "mesh_engine": mesh_engine_launches[spec.name],
                              "mesh_gateway": mesh_gateway_launches[spec.name],
                              "engine_adapter": engine_launches[spec.name],
                              "unreal": unreal_launches[spec.name],
                              "recovery": recovery_launches[spec.name],
                              "elastic": elastic_launches[spec.name],
                              "elastic_mesh": elastic_mesh_launches[spec.name],
                              **{path: n[spec.name] for path, n in soak_launches.items()},
                              **{path: n[spec.name] for path, n in trace_obs_launches.items()},
                              **{path: n[spec.name] for path, n in chaos_launches.items()},
                              **{path: n[spec.name] for path, n in fleet_launches.items()},
                              **{path: n[spec.name] for path, n in crash_launches.items()},
                              **{path: n[spec.name]
                                 for path, n in fleet_live_launches.items()},
                              **{path: n[spec.name] for path, n in edge_launches.items()},
                              **{path: n[spec.name] for path, n in loss_launches.items()},
                              **{path: n[spec.name] for path, n in graft_launches.items()}},
            launches_by_path_notes={**{path: FLEET_LIVE_NOTE for path in fleet_live_launches},
                                    **{path: EDGE_NOTE for path in edge_launches}},
            library_ms=None, **entries[spec.name],
            sim_path=dict(sim_entries[spec.name], library_ms=None),
            mesh_path=dict(mesh_entries[spec.name], launches_per_mesh_tick={
                "entities": MESH_SHARDS if spec.name == "assign_count" else 1,
                "cells": MESH_SHARDS}),
            elastic_path=elastic_entries.get(spec.name, {}),
            elastic_mesh_path=elastic_mesh_entries.get(spec.name, {}),
            soak_path={path: {case: e[spec.name] for case, e in cases.items() if spec.name in e}
                       for path, cases in soak_entries.items()},
            trace_obs_path=trace_obs_entries[spec.name],
            chaos_overload_path=chaos_entries[spec.name],
            fleet_path=fleet_entries[spec.name],
            crash_path=crash_entries[spec.name],
            failover_balance_path=loss_entries[spec.name],
            graft_entry_path=graft_entries[spec.name],
        ))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
