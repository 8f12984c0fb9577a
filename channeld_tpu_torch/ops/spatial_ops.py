"""Batched spatial decision ops (PyTorch).

The port of ``channeld_tpu/ops/spatial_ops.py``: cell assignment,
handover detection and compaction, per-cell occupancy, AOI interest
masks, the fan-out due decision, the fused per-tick ``spatial_step``
with its single host-consumption blob, the standing-query diff
(``diff_query_masks``) and the simulation plane's step (``sim_step``).
Every function is a plain torch function on tensors and runs on
whatever device its inputs live on. ``spatial_step`` routes its two
heavy passes through the hand-written CUDA kernels of
``cuda_kernels.py`` (their wrappers take the plain path below for CPU
tensors).

Parity with the JAX package is exact on every int and bool output
(tests/test_torch_spatial_ops.py). Three places need care to get there:

- Division by a grid constant. The reference runs these ops inside
  ``jit`` with the grid static, and XLA's algebraic simplifier rewrites
  ``x / c`` for a constant ``c`` into ``x * (1/c)``, the reciprocal
  rounded to float32. That is the reference's real behaviour (its eager
  functions divide truly and disagree at cell boundaries when the cell
  size is not a power of two), so the port multiplies by
  ``reciprocal(c)`` explicitly, here and in the CUDA kernels. It never
  relies on ATen's own rewrite of division by a Python float on CUDA.
- XLA converts float32 to int32 with NaN -> 0 and saturation at the
  int32 range; torch's CPU cast gives INT_MIN for NaN and for anything
  out of range. ``assign_cells`` bounds-checks in float (NaN counts as
  column/row 0, as in XLA) and ``_f32_to_i32`` reproduces XLA's
  conversion, so no result depends on the C++ cast.
- Each arithmetic step is its own torch op, so nothing contracts a
  product and a sum into one FMA rounding.
- torch's float32 ``sqrt`` on the CPU is not correctly rounded (one ulp
  off on about 0.6% of inputs); XLA's, CUDA's and the kernels' roots
  are. Every root here is ``sqrt_rn``.

``sim_step``'s float outputs are held to the reference within a stated
tolerance (XLA:CPU contracts several of its product-sums into FMAs; the
port rounds each product) and are bit-identical between the port's CPU
and CUDA runs: every op rounds once in a fixed order, and the per-cell
sums add each cell's agents in ascending slot order on both
(``ordered_cell_sums``), where a float ``index_add_`` on CUDA would add
them in whatever order its atomics land.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GridSpec(NamedTuple):
    """Static grid geometry. Any object with these six fields works
    wherever a grid is taken (the JAX package's GridSpec included)."""

    offset_x: float
    offset_z: float
    cell_w: float
    cell_h: float
    cols: int
    rows: int

    @property
    def num_cells(self) -> int:
        return self.cols * self.rows

    @property
    def diagonal(self) -> float:
        return float((self.cell_w**2 + self.cell_h**2) ** 0.5)


def num_cells(grid) -> int:
    return int(grid.cols) * int(grid.rows)


def diagonal(grid) -> float:
    return float((grid.cell_w**2 + grid.cell_h**2) ** 0.5)


def reciprocal(value: float) -> float:
    """1/value as XLA folds it for a constant divisor: the float32
    reciprocal of the float32 value (see the module docstring)."""
    return float(np.float32(1.0) / np.float32(value))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on every device: the
    root is taken in float64 and rounded once to float32. The root of a
    float32 lies at least ~2^-49 (relative) from any float32 rounding
    boundary, far beyond a float64 root's error (torch's CPU and CUDA
    float64 roots differ in their last bit on some inputs, and still
    round to the same float32)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 conversion: truncate, NaN -> 0, saturate at
    the int32 range (torch's own cast is undefined there)."""
    big = x >= 2147483648.0
    small = x < -2147483648.0
    inside = torch.where(big | small | torch.isnan(x), 0.0, x).to(torch.int32)
    return torch.where(
        big, _I32_MAX, torch.where(small, _I32_MIN, inside)
    ).to(torch.int32)


# ---- cell assignment ------------------------------------------------------


def _grid_coord(p: torch.Tensor, offset: float, size: float, count: int):
    """(index i32, inside bool) of ``floor((p - offset) / size)`` along
    one axis, the division folded as XLA folds it, with XLA's conversion
    semantics: NaN lands on index 0, and
    anything outside [0, count) — ±inf and 1e20 included — is outside."""
    f = torch.floor((p - offset) * reciprocal(size))
    nan = torch.isnan(f)
    inside = ((f >= 0) & (f < count)) | nan
    return torch.where(inside & ~nan, f, 0.0).to(torch.int32), inside


def assign_cells(grid, positions: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """positions f32[N,3] -> cell index i32[N]; -1 for invalid/outside.

    (ref: spatial.go:169-180 GetChannelIdWithOffset, vectorized.)
    """
    gx, in_x = _grid_coord(positions[:, 0], grid.offset_x, grid.cell_w, grid.cols)
    gz, in_z = _grid_coord(positions[:, 2], grid.offset_z, grid.cell_h, grid.rows)
    inside = in_x & in_z & valid
    return torch.where(inside, gx + gz * int(grid.cols), -1).to(torch.int32)


# ---- handover detection ---------------------------------------------------


def detect_handovers(old_cell: torch.Tensor, new_cell: torch.Tensor) -> torch.Tensor:
    """bool[N]: entity crossed a cell boundary this tick
    (ref: spatial.go:613-626 src != dst check, batched)."""
    return (old_cell >= 0) & (new_cell >= 0) & (old_cell != new_cell)


def compact_handovers(
    handover_mask: torch.Tensor,
    old_cell: torch.Tensor,
    new_cell: torch.Tensor,
    max_out: int,
):
    """Pack (entity_slot, src_cell, dst_cell) rows for up to ``max_out``
    crossings into a fixed-shape output (count, rows i32[max_out,3],
    reported bool[N]).

    Fixed shapes keep the step free of host syncs; overflow beyond
    max_out is reported via count so the host can fall back next tick.
    """
    n = handover_mask.shape[0]
    max_out = min(max_out, n)
    dev = handover_mask.device
    count = handover_mask.sum(dtype=torch.int32)
    # Ordinal of each crossing among all crossings (slot order).
    rank = torch.cumsum(handover_mask, 0, dtype=torch.int32) - 1
    reported = handover_mask & (rank < max_out)
    # Scatter each reported slot's index into its rank; every unreported
    # slot writes into a discard lane at index max_out, sliced off below.
    slot = torch.where(reported, rank, max_out).to(torch.int64)
    idx = torch.zeros(max_out + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=dev))
    idx = idx[:max_out].to(torch.int64)
    rows = torch.stack([idx.to(torch.int32), old_cell[idx], new_cell[idx]], dim=1)
    row_valid = torch.arange(max_out, device=dev) < torch.clamp(count, max=max_out)
    rows = torch.where(row_valid[:, None], rows, -1).to(torch.int32)
    return count, rows, reported


# ---- per-cell occupancy ---------------------------------------------------


def cell_counts(cell_of: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Entity count per cell, i32[num_cells] (segment-sum)."""
    valid = cell_of >= 0
    counts = torch.zeros(num_cells, dtype=torch.int32, device=cell_of.device)
    return counts.index_add_(
        0, torch.where(valid, cell_of, 0).to(torch.int64), valid.to(torch.int32)
    )


# ---- AOI: query x cell interest masks ------------------------------------

AOI_NONE = 0
AOI_SPHERE = 1
AOI_BOX = 2
AOI_CONE = 3
AOI_SPOTS = 4


class QuerySet(NamedTuple):
    """SoA batch of client interest queries (ref: channeld.proto
    SpatialInterestQuery; one active shape per query).

    Spots queries don't reduce to a geometric test, so they ride as a
    precomputed per-query cell table (rasterized host-side when the query
    is set): one i32[Q,C] damping distance with -1 meaning "no interest"
    (the mask is ``dist >= 0``). The field stays ``None`` until the
    first spots query.
    """

    kind: torch.Tensor  # i32[Q] in {NONE, SPHERE, BOX, CONE, SPOTS}
    center: torch.Tensor  # f32[Q,2] (x,z)
    extent: torch.Tensor  # f32[Q,2] box half-extent (x,z); radius in [:,0] for sphere/cone
    direction: torch.Tensor  # f32[Q,2] cone direction (x,z), normalized
    angle: torch.Tensor  # f32[Q] cone half-angle, radians
    spot_dist: Optional[torch.Tensor] = None  # i32[Q,C]; -1 = no interest


def cell_centres(grid, cell_ids):
    """(x, z) f32[Cb] of the cells ``cell_ids``: ``(col + 0.5) * w + offset``,
    the product rounded before the sum (see ROADMAP.md, F6)."""
    cols = int(grid.cols)
    col = (cell_ids % cols).to(torch.float32)
    row = torch.div(cell_ids, cols, rounding_mode="floor").to(torch.float32)
    return (col + 0.5) * grid.cell_w + grid.offset_x, (row + 0.5) * grid.cell_h + grid.offset_z


def aoi_geometry(grid, kind, center, extent, direction, cos_angle, cell_ids):
    """Geometric interest of every query in the cells ``cell_ids``.

    Returns (hit bool[Q,Cb], dist i32[Q,Cb]). ``cos_angle`` is the cone
    threshold cos(angle) per query, computed once by the caller so the
    CUDA kernel and this plain version compare against the same value.
    Ids outside [0, num_cells) are padding and never hit. Each product
    and sum is a separate op (no FMA), mirroring the kernel's
    ``__fmul_rn``/``__fadd_rn``.
    """
    ccx, ccz = cell_centres(grid, cell_ids)  # [Cb]
    cell_valid = (cell_ids >= 0) & (cell_ids < num_cells(grid))
    half_w = grid.cell_w * 0.5
    half_h = grid.cell_h * 0.5

    qx = center[:, 0:1]
    qz = center[:, 1:2]
    ddx = qx - ccx[None, :]  # [Q,Cb]
    ddz = qz - ccz[None, :]
    dx = ddx.abs()
    dz = ddz.abs()
    gap_x = torch.maximum(dx - half_w, torch.zeros_like(dx))
    gap_z = torch.maximum(dz - half_h, torch.zeros_like(dz))
    rect_dist = sqrt_rn(gap_x * gap_x + gap_z * gap_z)
    # (c - q)^2 == (q - c)^2 exactly, so the centre distance and the
    # cone's ray length are one value.
    center_dist = sqrt_rn(ddx * ddx + ddz * ddz)

    radius = extent[:, 0:1]
    sphere_hit = rect_dist <= radius
    box_hit = (dx <= extent[:, 0:1] + half_w) & (dz <= extent[:, 1:2] + half_h)
    to_len = torch.maximum(center_dist, torch.full_like(center_dist, 1e-9))
    dot = (-ddx) * direction[:, 0:1] + (-ddz) * direction[:, 1:2]
    cosine = dot / to_len
    in_angle = cosine >= cos_angle[:, None]
    apex_cell = rect_dist <= 0.0
    cone_hit = (rect_dist <= radius) & (in_angle | apex_cell)

    k = kind[:, None]
    hit = (
        ((k == AOI_SPHERE) & sphere_hit)
        | ((k == AOI_BOX) & box_hit)
        | ((k == AOI_CONE) & cone_hit)
    ) & cell_valid[None, :]
    dist = _f32_to_i32(torch.ceil(center_dist * reciprocal(diagonal(grid))))
    dist = torch.where(apex_cell, 0, dist).to(torch.int32)
    return hit, dist


def aoi_masks(grid, queries: QuerySet):
    """Interest of every query in every cell.

    Returns (interest bool[Q,C], dist i32[Q,C]) where dist is the
    ceil(center-to-sample / cell-diagonal) damping distance, matching the
    host path's metric (ref: spatial.go:182-317)."""
    ids = torch.arange(num_cells(grid), dtype=torch.int32, device=queries.kind.device)
    return aoi_masks_for_cells(grid, queries, ids, queries.spot_dist)


def aoi_masks_for_cells(grid, queries: QuerySet, cell_ids, spot_dist_slice=None):
    """``aoi_masks`` for an arbitrary i32[Cb] vector of GLOBAL cell ids
    (the cell-sharded plane computes one block of columns). Ids outside
    [0, num_cells) are padding: never interested. ``spot_dist_slice`` is
    the [Q, Cb] slice of the spots table for these cells (None = no spots
    queries registered)."""
    hit, dist = aoi_geometry(
        grid, queries.kind, queries.center, queries.extent,
        queries.direction, torch.cos(queries.angle), cell_ids,
    )
    return apply_spots_block(grid, hit, dist, queries.kind, cell_ids, spot_dist_slice)


def apply_spots_block(grid, hit, dist, kind, cell_ids, spot_dist_slice):
    """The spots overlay of ``aoi_masks_for_cells`` on geometric planes
    over the cells ``cell_ids``: a spots query's interest is its table's
    ``[Q, Cb]`` slice (``>= 0``) in cells inside the grid, with the
    table's dist there. ``spot_dist_slice`` None = no spots queries."""
    if spot_dist_slice is None:
        return hit, dist
    cell_valid = (cell_ids >= 0) & (cell_ids < num_cells(grid))
    is_spots = kind[:, None] == AOI_SPOTS
    spots_hit = (spot_dist_slice >= 0) & cell_valid[None, :]
    hit = torch.where(is_spots, spots_hit, hit)
    dist = torch.where(is_spots & spots_hit, spot_dist_slice, dist)
    return hit, dist


def apply_spots_overlay(hit, dist, queries: QuerySet):
    """Overlay spots queries' host-rasterized table onto geometric
    interest/dist planes (ref: spatial.go spots loop — each spot's cell
    with its per-spot dist, default 0; -1 = cell not targeted)."""
    if queries.spot_dist is None:
        return hit, dist
    is_spots = queries.kind[:, None] == AOI_SPOTS
    spots_hit = queries.spot_dist >= 0
    hit = torch.where(is_spots, spots_hit, hit)
    dist = torch.where(is_spots & spots_hit, queries.spot_dist, dist)
    return hit, dist


def damping_intervals_ms(
    dist: torch.Tensor,
    interest: torch.Tensor,
    tiers: torch.Tensor,
    tier_intervals: torch.Tensor,
    default_interval: int,
) -> torch.Tensor:
    """Map grid distance -> fan-out interval per (query, cell)
    (ref: message_spatial.go:10-38 damping table).

    ``tiers`` i32[T] ascending max-distances, ``tier_intervals`` i32[T].
    Beyond the last tier the default interval applies.
    """
    # Index of the first tier whose max_distance >= dist.
    idx = torch.searchsorted(tiers, dist.reshape(-1), right=False).reshape(dist.shape)
    in_table = idx < tiers.shape[0]
    interval = torch.where(
        in_table,
        tier_intervals[torch.clamp(idx, max=tiers.shape[0] - 1)],
        default_interval,
    )
    return torch.where(interest, interval, 0).to(tier_intervals.dtype)


# ---- fan-out due decision -------------------------------------------------


def fanout_due(
    now_ms,
    last_fanout_ms: torch.Tensor,
    interval_ms: torch.Tensor,
    active: torch.Tensor,
):
    """Which subscriptions are due, and their advanced window starts.

    Times are int32 milliseconds since engine start. Reproduces
    tick_data's window advance (ref: data.go:252-258): a due sub's
    last-fan-out moves to last+interval (not to ``now``), keeping late
    updates deliverable. Returns (due bool[S], new_last i32[S]).
    """
    next_ms = last_fanout_ms + interval_ms
    due = active & (next_ms <= now_ms)
    return due, torch.where(due, next_ms, last_fanout_ms)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits`` for a bool[S] tensor: u8[ceil(S/8)], big-endian
    bit order (the first element is the top bit), zero-padded."""
    pad = (-bits.shape[0]) % 8
    b = torch.nn.functional.pad(bits.to(torch.int32), (0, pad)).reshape(-1, 8)
    # Shifts made on the device: no host->device copy inside the step.
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b << shifts).sum(dim=1, dtype=torch.int32).to(torch.uint8)


# ---- the fused per-tick step ---------------------------------------------


def spatial_step(
    grid,
    positions: torch.Tensor,  # f32[N,3]
    prev_cell: torch.Tensor,  # i32[N]
    valid: torch.Tensor,  # bool[N]
    queries: QuerySet,
    sub_state: tuple,  # (last_fanout_ms i32[S], interval_ms i32[S], active bool[S])
    max_handovers: int,
    now_ms: int,
):
    """One decision tick on the inputs' device: cell assignment +
    handover detection/compaction + per-cell occupancy + AOI interest +
    fan-out due mask. Returns everything the host needs to route
    messages, under the JAX step's keys.

    The assign+count and AOI passes go through the CUDA kernels' wrappers
    (``cuda_kernels``), which launch the kernel for CUDA tensors and take
    the plain path for CPU tensors. The JAX step donates ``prev_cell``;
    here it is left untouched and the caller swaps in
    ``committed_prev``."""
    from .cuda_kernels import aoi_masks_cuda, assign_and_count

    cell_of, counts = assign_and_count(grid, positions, valid)
    handover_mask = detect_handovers(prev_cell, cell_of)
    ho_count, ho_rows, reported = compact_handovers(
        handover_mask, prev_cell, cell_of, max_handovers
    )
    # Crossings that overflowed the row budget keep their *old* cell as the
    # next tick's baseline, so they are re-detected instead of lost.
    committed_prev = torch.where(handover_mask & ~reported, prev_cell, cell_of)
    interest, dist = aoi_masks_cuda(grid, queries)
    last_ms, interval_ms, active = sub_state
    due, new_last = fanout_due(now_ms, last_ms, interval_ms, active)
    due_packed = packbits(due)
    # Single host-consumption blob: one D2H transfer per tick instead of
    # one per output. Layout (i32):
    #   [0]                count
    #   [1 : 1+3K]         handover rows, row-major
    #   [... : +C]         cell counts
    #   [... : +ceil(S/32)] due bitmask words (u8-packed, zero-padded,
    #                       4 bytes per little-endian int32 word)
    pad = (-due_packed.shape[0]) % 4
    due_words = torch.nn.functional.pad(due_packed, (0, pad)).view(torch.int32)
    consume = torch.cat([ho_count[None], ho_rows.reshape(-1), counts, due_words])
    return {
        "cell_of": cell_of,
        "committed_prev": committed_prev,
        "handover_count": ho_count,
        "handovers": ho_rows,
        "cell_counts": counts,
        "interest": interest,
        "dist": dist,
        "due": due,
        # Bit-packed due mask (unpack host-side with np.unpackbits).
        "due_packed": due_packed,
        "consume": consume,
        "new_last_fanout_ms": new_last,
    }


def parse_consume_blob(blob, max_handovers: int, num_cells: int, num_subs: int):
    """Host-side split of the packed consumption blob (numpy)."""
    blob = np.asarray(blob)
    count = int(blob[0])
    rows_end = 1 + 3 * max_handovers
    rows = blob[1:rows_end].reshape(max_handovers, 3)
    counts = blob[rows_end : rows_end + num_cells]
    due_words = blob[rows_end + num_cells :]
    due = np.unpackbits(due_words.view(np.uint8))[:num_subs]
    return count, rows, counts, due


# ---- standing-query diff / compaction (doc/query_engine.md) ---------------


def diff_query_masks(
    prev_interest: torch.Tensor,  # bool[Q,C] committed baseline
    prev_dist: torch.Tensor,  # i32[Q,C]
    interest: torch.Tensor,  # bool[Q,C] this tick's masks
    dist: torch.Tensor,  # i32[Q,C]
    max_rows: int,
):
    """Diff this tick's query-interest masks against the committed
    baseline on the device and compact the delta to ``(query, cell,
    dist)`` rows — the standing-query plane's entire per-tick host
    protocol.

    A (q, c) entry is *changed* when interest flipped either way, or when
    it stayed interested but the damping distance moved. Rows carry the
    NEW dist; ``dist == -1`` means interest was removed. Changes beyond
    ``max_rows`` (clamped to Q*C) keep their *previous* baseline value so
    they re-diff next tick instead of being lost; ``count`` reports the
    true total so the host can see the backlog.

    Returns (blob i32[1+3*max_rows], next_interest bool[Q,C],
    next_dist i32[Q,C]): blob = [count][rows row-major], rows past
    min(count, max_rows) are -1. The k-th changed entry in row-major
    order is found by a binary search of the inclusive running count for
    k+1 (the same rows as the reference's rank scatter, without
    scattering every unchanged entry into one discard lane)."""
    q, c = interest.shape
    max_rows = min(max_rows, q * c)
    dev = interest.device
    changed = (interest != prev_interest) | (interest & (dist != prev_dist))
    flat = changed.reshape(-1)
    count = flat.sum(dtype=torch.int32)
    running = torch.cumsum(flat, 0, dtype=torch.int32)
    rank = running - 1
    reported = flat & (rank < max_rows)
    wanted = torch.arange(1, max_rows + 1, dtype=torch.int32, device=dev)
    row_valid = wanted <= count
    idx = torch.where(row_valid, torch.searchsorted(running, wanted), 0)
    new_dist = torch.where(interest.reshape(-1)[idx], dist.reshape(-1)[idx], -1)
    rows = torch.stack([torch.div(idx, c, rounding_mode="floor"), idx % c, new_dist], dim=1)
    rows = torch.where(row_valid[:, None], rows, -1).to(torch.int32)
    keep_prev = changed & ~reported.reshape(q, c)
    next_interest = torch.where(keep_prev, prev_interest, interest)
    next_dist = torch.where(keep_prev, prev_dist, dist)
    blob = torch.cat([count[None], rows.reshape(-1)])
    return blob, next_interest, next_dist


def parse_query_blob(blob):
    """Host-side split of the standing-query changed-rows blob (numpy):
    (total_changed, rows i32[R,3]) where R is the blob's own row budget
    (``diff_query_masks`` clamps the configured max to Q*C, so the
    effective budget is read from the blob, never assumed); rows beyond
    min(total, R) are -1 padding."""
    blob = np.asarray(blob)
    return int(blob[0]), blob[1:].reshape(-1, 3)


# ---- simulation plane: agent steering + behavior FSM (doc/simulation.md) --

SIM_IDLE = 0
SIM_WANDER = 1
SIM_SEEK = 2
SIM_FLEE = 3


class SimParams(NamedTuple):
    """Steering/FSM constants of the sim step (the ``sim_*`` knob table
    in doc/simulation.md)."""

    dt: float  # integration step, seconds of world time per tick
    max_speed: float  # clamp on |v|, world units / s
    accel: float  # max steering acceleration, world units / s^2
    separation: float  # crowded-cell push weight
    cohesion: float  # sparse-cell centroid pull weight
    arrive_radius: float  # waypoint reached within this xz distance
    crowd: int  # cell occupancy above which separation wins
    p_wander: float  # per-tick idle -> wander probability
    p_seek: float  # per-tick wander -> seek probability
    p_idle: float  # per-tick wander -> idle probability


_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant ``k``
    < 2^32, without leaving int64: k is split into 16-bit halves so no
    partial product reaches 2^63 (torch has no usable uint32 arithmetic
    on the CPU)."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _rand_lanes(seed: int, tick: int, first_lane: int, lanes: int, n: int,
                device) -> torch.Tensor:
    """``sim_rand_u32`` for lanes first_lane .. first_lane+lanes-1 at
    once: int64[lanes, n]."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    lane = torch.arange(first_lane, first_lane + lanes, dtype=torch.int64, device=device)
    x = (_mul_u32(idx, 0x9E3779B9) + (int(seed) & _U32)) & _U32
    x = x ^ (((int(tick) & _U32) * 0x85EBCA6B) & _U32)
    x = (x + _mul_u32(lane[:, None] & _U32, 0xC2B2AE35)) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sim_rand_u32(seed: int, tick: int, lane: int, n: int, device=None) -> torch.Tensor:
    """Counter-based RNG: the u32[n] hash of (seed, tick, lane, slot),
    as int64 values in [0, 2^32), bit-exact against the reference.

    Stateless and replayable — the same (seed, tick) always produces the
    same draws regardless of history. A Weyl-sequence input through the
    murmur3 fmix32 finalizer. ``seed``, ``tick`` and ``lane`` are taken
    modulo 2^32 (the reference casts them to uint32)."""
    return _rand_lanes(seed, tick, int(lane), 1, n, device)[0]


def _unit_f32(bits: torch.Tensor) -> torch.Tensor:
    """u32 -> f32 uniform in [0, 1) (top 24 bits, exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _f32(value: float) -> float:
    """A Python constant rounded to float32 where the reference's weak
    typing rounds it (every later op then rounds the same way whether
    the backend computes a scalar op in float or double)."""
    return float(np.float32(value))


def ordered_cell_sums(cell: torch.Tensor, live: torch.Tensor, values: torch.Tensor,
                      num_cells: int):
    """Per-cell (count f32[C], sum f32[C,2]) of ``values`` f32[N,2] over
    the ``live`` slots, each cell's values added one at a time in
    ascending slot order, starting from 0 — what the reference's
    sequential scatter-add does.

    The slots are stably sorted by cell (non-live ones into a trailing
    segment C), and ``torch.segment_reduce`` folds each segment of the
    sorted [N,2] rows front to back (one sequential loop per segment and
    column, on the CPU and on CUDA). The order, and so every bit of the
    result, is the same on both devices and in every run. Counts are
    integer counts, exact.

    The reference scatters every non-live slot into cell 0 with weight 0:
    a finite value adds ±0 (no change), a NaN or ±inf one makes cell 0's
    sum NaN. That is reproduced after the fold."""
    segment = torch.where(live, cell, num_cells).to(torch.int64)
    order = torch.sort(segment, stable=True).indices
    # Integer counts (not torch.bincount, which reads the largest key
    # back to the host to size its output).
    lengths = torch.zeros(num_cells + 1, dtype=torch.int64, device=cell.device)
    lengths.index_add_(0, segment, torch.ones_like(segment))
    sums = torch.segment_reduce(values[order], "sum", lengths=lengths, unsafe=True)
    sums = sums[:num_cells]
    poison = (~live[:, None] & ~torch.isfinite(values)).any(dim=0)
    sums[0] = torch.where(poison, float("nan"), sums[0])
    return lengths[:num_cells].to(torch.float32), sums


def _norm2(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """sqrt(x*x + z*z), each product rounded on its own."""
    return sqrt_rn(x * x + z * z)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| of f32[N,3] as sqrt((a*a + b*b) + c*c), in that order, [N,1]."""
    a, b, c = v.unbind(1)
    return sqrt_rn((a * a + b * b) + c * c)[:, None]


def sim_step(
    grid,
    positions: torch.Tensor,  # f32[N,3]
    vel: torch.Tensor,  # f32[N,3]
    state: torch.Tensor,  # i32[N] FSM state
    target: torch.Tensor,  # f32[N,3] current waypoint
    agent: torch.Tensor,  # bool[N] slot hosts a simulated agent
    flee_cells: torch.Tensor,  # bool[C] danger mask (query-plane sensor hits)
    params: SimParams,
    seed: int,
    tick: int,
):
    """One population step on the inputs' device: flocking steering from
    per-cell occupancy aggregates, waypoint seeking, and the 4-state
    behavior FSM — branch-free over the SAME entity arrays the spatial
    pass reads, so the new positions feed straight into cell assignment
    with zero extra transfers.

    Flocking is the per-cell reduction of boids: separation pushes out of
    crowded cells and cohesion pulls strays toward their cell centroid,
    from O(N) per-cell sums. FLEE is driven by ``flee_cells``, the
    host-rasterized mask of sensor hits.

    Non-agent lanes (humans, free slots) pass through every output
    unchanged. Returns new (positions, vel, state, target) tensors and
    writes none of its inputs (the reference donates them; here an
    abandoned tick leaves the caller's columns whole)."""
    n = positions.shape[0]
    dev = positions.device
    c = num_cells(grid)
    cols = int(grid.cols)
    cell_of = assign_cells(grid, positions, agent)
    in_world = cell_of >= 0
    safe_cell = torch.where(in_world, cell_of, 0).to(torch.int64)
    live = agent & in_world

    # Per-cell occupancy + centroid of the agent population (xz plane).
    xz = positions[:, 0::2]  # columns 0 and 2
    counts, sums = ordered_cell_sums(safe_cell, live, xz, c)
    centroid = sums / torch.clamp(counts, min=1.0)[:, None]
    my_count = counts[safe_cell]
    away = xz - centroid[safe_cell]
    away_len = _norm2(away[:, 0], away[:, 1])[:, None]
    away_dir = away / torch.clamp(away_len, min=1e-6)
    crowded = (my_count > params.crowd)[:, None]
    steer_xz = torch.where(
        crowded,
        away_dir * _f32(params.separation),
        -away_dir * torch.clamp(away_len, max=1.0) * _f32(params.cohesion),
    )

    # FSM transitions. One dice lane per decision: 0 transition, 1-2
    # waypoint, 3-4 jitter.
    r = _unit_f32(_rand_lanes(seed, tick, 0, 5, n, dev))
    r_trans = r[0]
    to_t = target - positions
    dist_t = _norm2(to_t[:, 0], to_t[:, 2])
    arrived = dist_t <= _f32(params.arrive_radius)
    in_danger = live & flee_cells[safe_cell]

    st = state
    p_seek = _f32(params.p_seek)
    new_st = torch.where((st == SIM_SEEK) & arrived, SIM_IDLE, st)
    is_wander = st == SIM_WANDER
    new_st = torch.where(is_wander & (r_trans < p_seek), SIM_SEEK, new_st)
    new_st = torch.where(
        is_wander & (r_trans >= p_seek) & (r_trans < _f32(params.p_seek + params.p_idle)),
        SIM_IDLE, new_st,
    )
    new_st = torch.where((st == SIM_IDLE) & (r_trans < _f32(params.p_wander)),
                         SIM_WANDER, new_st)
    # Sensor hits override everything; an escaped fleer calms to WANDER.
    new_st = torch.where(
        in_danger, SIM_FLEE,
        torch.where((st == SIM_FLEE) & ~in_danger, SIM_WANDER, new_st),
    ).to(torch.int32)

    # Waypoints: a fresh SEEK draws a world-uniform target; FLEE aims at
    # the reflection of the danger cell's center through the agent.
    ox, oz = _f32(grid.offset_x), _f32(grid.offset_z)
    rand_target = torch.stack([
        r[1] * _f32(grid.cols * grid.cell_w) + ox,
        positions[:, 1],
        r[2] * _f32(grid.rows * grid.cell_h) + oz,
    ], dim=1)
    col = (safe_cell % cols).to(torch.float32)
    row = torch.div(safe_cell, cols, rounding_mode="floor").to(torch.float32)
    cell_cx = (col + 0.5) * _f32(grid.cell_w) + ox
    cell_cz = (row + 0.5) * _f32(grid.cell_h) + oz
    flee_target = torch.stack([
        positions[:, 0] * 2.0 - cell_cx,
        positions[:, 1],
        positions[:, 2] * 2.0 - cell_cz,
    ], dim=1)
    entered_seek = (new_st == SIM_SEEK) & (st != SIM_SEEK)
    entered_flee = (new_st == SIM_FLEE) & (st != SIM_FLEE)
    new_target = torch.where(entered_seek[:, None], rand_target, target)
    new_target = torch.where(entered_flee[:, None], flee_target, new_target)

    # Desired velocity by state (xz plane; y is carried, never integrated).
    max_speed = _f32(params.max_speed)
    to_nt = new_target - positions
    nt_len = _norm2(to_nt[:, 0], to_nt[:, 2])
    goal_dir = to_nt / torch.clamp(nt_len, min=1e-6)[:, None]
    jitter = torch.stack([
        r[3] * 2.0 - 1.0, torch.zeros(n, dtype=torch.float32, device=dev), r[4] * 2.0 - 1.0,
    ], dim=1)
    seeking = (new_st == SIM_SEEK) | (new_st == SIM_FLEE)
    desired = torch.where(
        seeking[:, None],
        goal_dir * max_speed,
        torch.where(
            (new_st == SIM_WANDER)[:, None],
            vel * _f32(0.9) + jitter * max_speed * 0.5,
            torch.zeros_like(vel),
        ),
    )
    desired = torch.stack([
        desired[:, 0] + steer_xz[:, 0] * max_speed,
        desired[:, 1],
        desired[:, 2] + steer_xz[:, 1] * max_speed,
    ], dim=1)

    # Accelerate toward desired, clamp speed, integrate, clamp into the
    # world (a clamped agent stays assignable).
    dv = desired - vel
    dv_len = _norm3(dv)
    step = torch.clamp(dv_len, max=_f32(params.accel * params.dt))
    new_vel = vel + dv / torch.clamp(dv_len, min=1e-6) * step
    speed = _norm3(new_vel)
    # A tensor numerator: ``scalar / tensor`` would be taken as
    # reciprocal(tensor) * scalar.
    scale = torch.clamp(torch.full_like(speed, max_speed) / torch.clamp(speed, min=1e-6),
                        max=1.0)
    new_vel = new_vel * scale
    new_vel = torch.stack([new_vel[:, 0], torch.zeros_like(new_vel[:, 1]), new_vel[:, 2]],
                          dim=1)
    new_pos = positions + new_vel * _f32(params.dt)
    margin = np.float32(min(grid.cell_w, grid.cell_h) * 1e-3)
    lo_x = float(np.float32(grid.offset_x) + margin)
    hi_x = float(np.float32(grid.offset_x + grid.cols * grid.cell_w) - margin)
    lo_z = float(np.float32(grid.offset_z) + margin)
    hi_z = float(np.float32(grid.offset_z + grid.rows * grid.cell_h) - margin)
    new_pos = torch.stack([
        torch.clamp(new_pos[:, 0], min=lo_x, max=hi_x),
        new_pos[:, 1],
        torch.clamp(new_pos[:, 2], min=lo_z, max=hi_z),
    ], dim=1)

    lane = agent[:, None]
    return (
        torch.where(lane, new_pos, positions),
        torch.where(lane, new_vel, vel),
        torch.where(agent, new_st, state),
        torch.where(lane, new_target, target),
    )
