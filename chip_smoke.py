#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --gateway 50000 30   # phase 6a alone, at another size

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
7. if grpc and protobuf are installed, one real sidecar round trip on
   ``cuda`` (otherwise says it was not run).

The line before the last is a JSON object with one entry per kernel
(times measured in this run at the sidecar path's shapes; bound from
this run's shapes; ``ms`` is the kernel alone by events, ``call_ms`` one
wrapper call; ``launches`` on the sidecar path, ``launches_by_path`` on
each path (the gateway's shapes are the sidecar's), ``sim_path`` the
same figures at the sim world's shapes); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
    return entries


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
              entityCapacity=0, queryCapacity=0, subCapacity=0, meshDevices=0)


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
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / n, e.count // n)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
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
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / n, e.count / n)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
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
        s.sim_enabled = True
        s.sim_census_every_ticks = size["census_every"]
        s.device_step_deadline_s = GATEWAY_DEADLINE_S
        P.message.init_message_map()
        P.channel.init_channels()
        P.sim_models.register_sim_types()
        t0 = time.perf_counter()
        P.controller.init_spatial_controller(GATEWAY_CONFIG)
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
        return dict(
            handovers=[r for rows in self.handovers[crossings:] for r in rows], q=(count, digest([rows[: min(count, len(rows))]])[0]),
            tables=tables.hexdigest(),
            sent={c.id: (c.count, c.digest.hexdigest()) for c in self.conns},
            guard=(guard.state.name, dict(guard.failure_counts), guard.held_ticks),
            sim=digest(sim_columns(eng)), census=census,
            tick_ms=(t3 - t0) * 1e3, global_ms=(t2 - t1) * 1e3,
            step_ms=self.step_ms[steps] if len(self.step_ms) > steps else None,
            reads=reads.count, syncs=reads.syncs)

    def close(self) -> None:
        self._unwrap()
        reset_gateway(self.P)


def first_gateway_diff(a: dict, b: dict) -> Optional[str]:
    """The first observation of one tick that differs between the legs,
    with its detail (None when the tick is equal)."""
    for key in ("handovers", "tables", "q", "sim", "census", "guard"):
        if a[key] != b[key]:
            if key == "handovers":
                i = next((i for i, (x, y) in enumerate(zip(a[key], b[key])) if x != y),
                         min(len(a[key]), len(b[key])))
                return (f"handovers: {len(a[key])} vs {len(b[key])}, first differing "
                        f"row {i}: {a[key][i:i + 1]} vs {b[key][i:i + 1]}")
            return f"{key}: {str(a[key])[:200]} vs {str(b[key])[:200]}"
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
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / n, e.count / n)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
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

    def stats(xs):
        return f"median {statistics.median(xs):.3f} ms p99 {float(np.percentile(xs, 99)):.3f} ms"

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
              f"{stats([o['tick_ms'] for o in legs[1:]])}; GLOBAL tick "
              f"{stats([o['global_ms'] for o in legs[1:]])}; guarded device step "
              f"{stats([o['step_ms'] for o in legs[1:]])}; host share "
              f"{stats([1 - o['step_ms'] / o['tick_ms'] for o in legs[1:]]).replace(' ms', '')}")
    print(f"fan-out decision (tick_data of a channel with subscribers, perf_counter): cuda "
          f"{stats(fanout_ms)} over {len(fanout_ms)} passes; cpu {stats(cpu_fanout)}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--gateway"]:
        return main_gateway(int(sys.argv[2]), int(sys.argv[3]))
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
                              "gateway": gateway_launches[spec.name]},
            library_ms=None, **entries[spec.name],
            sim_path=dict(sim_entries[spec.name], library_ms=None),
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
