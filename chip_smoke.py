#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

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
6. if grpc and protobuf are installed, one real sidecar round trip on
   ``cuda`` (otherwise says it was not run).

The line before the last is a JSON object with one entry per kernel
(times measured in this run at the sidecar path's shapes; bound from
this run's shapes; ``ms`` is the kernel alone by events, ``call_ms`` one
wrapper call; ``launches`` on the sidecar path, ``launches_by_path`` on
each path, ``sim_path`` the same figures at the sim world's shapes); the
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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
                              "sim_world": sim_launches[spec.name]},
            library_ms=None, **entries[spec.name],
            sim_path=dict(sim_entries[spec.name], library_ms=None),
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
