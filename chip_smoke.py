#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --gateway 50000 30   # phase 6a alone, at another size
    python3 chip_smoke.py --mesh               # phase 7 alone
    python3 chip_smoke.py --engine-adapter 10000 12   # phase 8a alone, at another size

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
      spatial servers and the master) with 20,000 moving entity channels
      (cut from the bench's 50,000; ``--gateway ENTITIES TICKS`` runs
      this phase alone at any size), a storm of entities // 8 twice,
      the standing-query plane and the sim plane at the gateway
      defaults, 256 followers, 1,024 sensors and subscriptions at
      33-200 ms, the device guard on, 12 GLOBAL ticks on a fixed clock,
      in-process with stub connections, on ``cuda`` and then on the
      CPU. Every tick's handovers, spatial entity tables, every
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
      config4 at the gateway's default capacities: 10,000 objects
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
   ``cuda`` (otherwise says it was not run).

The line before the last is a JSON object with one entry per kernel
(times measured in this run at the sidecar path's shapes; bound from
this run's shapes; ``ms`` is the kernel alone by events, ``call_ms`` one
wrapper call; ``launches`` on the sidecar path, ``launches_by_path`` on
each path (the gateway's shapes are the sidecar's), ``sim_path`` the
same figures at the sim world's shapes, ``mesh_path`` at one shard's
shapes of phase 7 with the launches per mesh tick, ``fused_block`` K2's
fused-centre block of the cells plane beside the unfused launch); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace as NS
from typing import Optional

import numpy as np
import torch

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
# Phase 3's shapes: (label, grid, slots or queries, input). The first of
# each kernel is the main path's shape, which the JSON line reports.
K1_CASES = (("15x15", BENCH_GRID, 1 << 17, "uniform"),
            ("15x15 crowd", BENCH_GRID, 1 << 17, "crowd"),
            ("15x15 1M", BENCH_GRID, 1 << 20, "uniform"),
            ("256x256", WIDE_GRID, 1 << 17, "uniform"),
            ("256x256 crowd", WIDE_GRID, 1 << 17, "crowd"))
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


def entity_inputs(grid, n: int, rng: np.random.Generator, device, crowd: bool = False):
    """Positions over the grid and a margin around it, a quarter exactly
    on cell boundaries, plus NaN/±inf/1e20 rows and invalid slots. A
    crowd puts half of the slots, valid, inside one cell."""
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
    if crowd:
        idx = rng.permutation(n)[: n // 2]
        pos[idx, 0] = grid.offset_x + grid.cell_w * (7 + rng.random(idx.size))
        pos[idx, 2] = grid.offset_z + grid.cell_h * (7 + rng.random(idx.size))
        valid[idx] = True
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
        yield (label, grid, *entity_inputs(grid, n, rng, dev, crowd=what == "crowd"))


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
        check(shared == (grid.cols == 15), f"K1 {label}: wrong histogram path")
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
# 1,024 sensors and subscriptions at 33-200 ms. Cut to fit the phase:
# 20,000 entities (the full claim is 50,000: BASELINE #4, the bench's
# --entities 50000) and 12 ticks; the census every ticks // 3 (default
# 50) so censuses fall inside the run. ``--gateway ENTITIES TICKS`` runs
# the phase alone at another size.
GATEWAY_CONFIG = "config/spatial_tpu_benchmark.json"
GATEWAY_ENTITIES, GATEWAY_TICKS = 20_000, 12


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

    def send(self, ctx) -> None:
        body = ctx.raw_body
        if body is None:
            body = ctx.msg.SerializeToString(deterministic=True) if ctx.msg is not None else b""
        self.digest.update(np.array([ctx.msg_type, ctx.channel_id, len(body)], np.int64).tobytes())
        self.digest.update(body)
        self.count += 1

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

    def has_authority_over(self, ch) -> bool:
        gch = self.P.channel.get_global_channel()
        return (gch is not None and gch.get_owner() is self) or ch.get_owner() is self

    def remote_addr(self):
        return ("127.0.0.1", 10000 + self.id)

    def remote_ip(self):
        return "127.0.0.1"

    def disconnect(self):
        pass


def gateway_modules() -> NS:
    import importlib

    names = dict(channel="core.channel", connection="core.connection", data="core.data",
                 ddos="core.ddos", recovery="core.connection_recovery",
                 message="core.message", settings="core.settings", types="core.types",
                 sub="core.subscription", overload="core.overload", guard="core.device_guard",
                 wal="core.wal", slo="core.slo", tracing="core.tracing", events="core.events",
                 control_pb2="protocol.control_pb2", sim_pb2="models.sim_pb2",
                 sim_models="models.sim", controller="spatial.controller",
                 balancer="spatial.balancer", partition="spatial.partition",
                 metrics="core.metrics",
                 sim_plane="sim.plane", ops="ops.spatial_ops", logger="utils.logger")
    return NS(**{k: importlib.import_module(f"channeld_tpu_torch.{v}") for k, v in names.items()})


def reset_gateway(P) -> None:
    """Every process-wide registry of the port's gateway back to boot."""
    P.channel.reset_channels()
    P.connection.reset_connections()
    P.data.reset_registries()
    P.ddos.reset_ddos()
    P.recovery.reset_recovery()
    P.controller.reset_spatial_controller()
    P.overload.reset_overload()
    P.guard.reset_device_guard()
    P.balancer.reset_balancer()
    P.partition.reset_partition()
    P.wal.reset_wal()
    P.slo.reset_slo()
    P.tracing.reset_tracing()
    P.sim_plane.reset_sim()
    P.events.reset_all()
    P.settings.reset_global_settings()


class GatewayWorld:
    """Phase 6a's world on one device: the port's gateway on
    GATEWAY_CONFIG with real entity channels (created as
    scripts/chaos_soak.py's EntitySim creates them), stub connections
    for the master, the 9 servers and the clients, driven in a fixed
    order each GLOBAL tick: moves, entity channels, GLOBAL (the
    controller's guarded device step), spatial channels."""

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
        s.device_step_deadline_s = GATEWAY_DEADLINE_S
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
        P, ctl = self.P, self.ctl
        x0, z0 = ctl.world_offset_x + 1.0, ctl.world_offset_z + 1.0
        x1 = ctl.world_offset_x + ctl.grid_width * ctl.grid_cols - 1.0
        z1 = ctl.world_offset_z + ctl.grid_height * ctl.grid_rows - 1.0
        self.bounds = (x0, z0, x1, z1)
        estart = P.settings.global_settings.entity_channel_id_start
        SpatialInfo = P.controller.SpatialInfo
        self.positions: dict[int, tuple[float, float]] = {}
        self.entity_channels = []
        for i in range(self.size["entities"]):
            eid = estart + 1 + i
            x, z = rng.uniform(x0, x1), rng.uniform(z0, z1)
            info = SpatialInfo(x, 0, z)
            cell_ch = P.channel.get_channel(ctl.get_channel_id(info))
            owner = cell_ch.get_owner()
            ch = P.channel.create_entity_channel(eid, owner)
            d = P.sim_pb2.SimEntityChannelData()
            d.state.entityId = eid
            d.state.transform.position.x = x
            d.state.transform.position.z = z
            ch.init_data(d, None)
            ch.spatial_notifier = ctl
            P.sub.subscribe_to_channel(owner, ch, None)
            cell_ch.execute(lambda c, e=eid, dd=d: c.get_data_message().add_entity(e, dd))
            ctl.track_entity(eid, info)
            self.positions[eid] = (x, z)
            self.entity_channels.append(ch)
        self.entity_ids = list(self.positions)

    def _clients(self, rng) -> None:
        P, ctl, size = self.P, self.ctl, self.size
        x0, z0, x1, z1 = self.bounds
        ops = P.ops
        for i in range(size["followers"]):  # spheres and cones following entities
            client = self.conn(1000 + i, "CLIENT")
            eid = self.entity_ids[rng.randrange(len(self.entity_ids))]
            if i % 2:
                ctl.register_follow_interest(client, eid, ops.AOI_CONE, extent=(4000.0, 0.0),
                                             direction=(1.0, 0.0), angle=0.6)
            else:
                ctl.register_follow_interest(client, eid, ops.AOI_SPHERE, extent=(3000.0, 0.0))
        for i in range(size["sensors"]):  # static server sensors, box and sphere
            ctl.register_sensor(f"sensor{i}", kind=(ops.AOI_BOX, ops.AOI_SPHERE)[i % 2],
                                center=(rng.uniform(x0, x1), rng.uniform(z0, z1)),
                                extent=(rng.uniform(1500, 5000), rng.uniform(1500, 5000)))
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
        check(result is not None, f"tick {t}: the engine did not step")
        count, rows = eng.query_changed_rows(result)
        census = "sim_census" in result
        tables = hashlib.sha256()
        for cid in self.spatial:
            tables.update(chans[cid].get_data_message().SerializeToString(deterministic=True))
        guard = P.guard.guard
        overflow = P.metrics.tpu_cell_overflow_total._value.get()
        delta = int(overflow - getattr(self, "overflow_total", overflow))
        self.overflow_total = overflow
        return dict(
            handovers=[r for rows in self.handovers[crossings:] for r in rows], q=(count, digest([rows[: min(count, len(rows))]])[0]),
            tables=tables.hexdigest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns},
            guard=(guard.state.name, dict(guard.failure_counts), guard.held_ticks),
            sim=digest(sim_columns(eng)) if eng._d_vel is not None else None, census=census,
            overflow=delta, undelivered=eng.undelivered_slots(result),
            tick_ms=(t3 - t0) * 1e3, global_ms=(t2 - t1) * 1e3,
            step_ms=self.step_ms[steps] if len(self.step_ms) > steps else None,
            reads=reads.count, syncs=reads.syncs)

    def close(self) -> None:
        self._unwrap()
        reset_gateway(self.P)


def first_gateway_diff(a: dict, b: dict) -> Optional[str]:
    """The first observation of one tick that differs between the legs,
    with its detail (None when the tick is equal)."""
    for key in ("handovers", "tables", "q", "sim", "census", "guard", "overflow", "undelivered",
                "recovery"):
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


def phase_gateway_lockstep(K, dev, size: dict) -> dict:
    """6a: the port's gateway on the card against a lockstep CPU run of
    it, tick for tick. Returns K1/K2 launches on this path."""
    ticks = size["ticks"]
    t_phase = time.perf_counter()
    with FixedClock() as clock:
        world = GatewayWorld(dev, clock, size)
        setup_s = world.load_s
        K.reset_launch_counts()
        card = [world.tick(t) for t in range(ticks)]
        launches = K.launch_counts()
        for name, count in launches.items():
            check(count == ticks, f"kernel {name} launched {count} times in {ticks} gateway ticks")
        gateway_live_kernels(K, world.eng)
        agents = world.eng.agent_count()
        prof = profile_gateway(world, ticks)
        fanout_ms, step_ms = world.fanout_ms, world.step_ms
        world.close()
        del world
    t_card = time.perf_counter()
    with FixedClock() as clock:
        world = GatewayWorld(torch.device("cpu"), clock, size)
        cpu = []
        for t in range(ticks):
            cpu.append(world.tick(t))
            where = first_gateway_diff(card[t], cpu[t])
            check(where is None, f"gateway tick {t}: cuda and cpu differ: {where}")
        cpu_fanout = world.fanout_ms
        world.close()
        del world
    secs = (time.perf_counter() - t_phase, t_card - t_phase)

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
          f"phase {secs[0]:.1f} s (card leg {secs[1]:.1f} s, load_config {setup_s:.2f} s)")
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
# tick on the card's host): 10,000 objects x 12 ticks. 8b: the Unreal
# types, 1,000 objects x 6 ticks. ``--engine-adapter OBJECTS TICKS``
# runs 8a alone at another size.
ENGINE_OBJECTS, ENGINE_TICKS = 10_000, 12
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
              f"authenticated, not all {connections}")
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



def main_gateway(entities: int, ticks: int) -> int:
    """Phase 6a alone at another size (after the device and build
    phases): ``python3 chip_smoke.py --gateway 50000 30``."""
    from channeld_tpu_torch.ops import cuda_kernels as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        name, _ = phase_device()
        phase_build(K)
        phase_gateway_lockstep(K, dev, gateway_size(entities, ticks))
    except PhaseFailed as e:
        print(f"FAILED: {e}")
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
        print(f"FAILED: {e}")
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
        print(f"FAILED: {e}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--gateway"]:
        return main_gateway(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--mesh"]:
        return main_mesh()
    if sys.argv[1:2] == ["--engine-adapter"]:
        return main_engine_adapter(int(sys.argv[2]), int(sys.argv[3]))
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops import engine as engine_mod
    from channeld_tpu_torch.ops import service
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        name, _ = phase_device()
        phase_build(K)
        entries = phase_kernels(K, ops, dev)
        launches = phase_main_path(K, service, dev)
        sim_launches, sim_entries = phase_sim_world(K, engine_mod, ops, dev)
        gateway_launches = phase_gateway_lockstep(K, dev, gateway_size())
        phase_gateway_live()
        phase_gateway_threads(K, engine_mod, ops, dev)
        mesh_launches, mesh_entries = phase_mesh_steps(K, ops)
        mesh_engine_launches = phase_mesh_engine(K, engine_mod, ops)
        mesh_gateway_launches = phase_mesh_gateway(K)
        engine_launches = phase_engine_adapter(K, engine_size())
        unreal_launches = phase_unreal(K)
        phase_replay_live()
        phase_native_codec()
        phase_sidecar(service, dev)
    except PhaseFailed as e:
        print(f"FAILED: {e}")
        return 1
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
                              "unreal": unreal_launches[spec.name]},
            library_ms=None, **entries[spec.name],
            sim_path=dict(sim_entries[spec.name], library_ms=None),
            mesh_path=dict(mesh_entries[spec.name], launches_per_mesh_tick={
                "entities": MESH_SHARDS if spec.name == "assign_count" else 1,
                "cells": MESH_SHARDS}),
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
