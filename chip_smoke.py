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
5. if grpc and protobuf are installed, one real sidecar round trip on
   ``cuda`` (otherwise says it was not run).

The line before the last is a JSON object with one entry per kernel
(times measured in this run; bound from this run's shapes; ``ms`` is
the kernel alone by events, ``call_ms`` one wrapper call); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace as NS

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
    from channeld_tpu_torch.ops import service
    from channeld_tpu_torch.ops import spatial_ops as ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        name, _ = phase_device()
        phase_build(K)
        entries = phase_kernels(K, ops, dev)
        launches = phase_main_path(K, service, dev)
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
            library_ms=None, **entries[spec.name],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
