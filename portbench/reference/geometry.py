"""The spatial decision in plain NumPy float32: cells, crossings, occupancy,
areas of interest, the due fan-out.

What the engine states, op for op: a position's cell is
``floor((p - offset) * (1/size))`` with the reciprocal rounded to float32
(the rounding the engine pins at cell boundaries); NaN lands in column or
row 0, anything outside the grid (±inf, 1e20) in no cell; every product and
sum of the interest test is rounded on its own; roots are IEEE roots
(NumPy's float32 ``sqrt`` is correctly rounded).
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32

AOI_NONE, AOI_SPHERE, AOI_BOX, AOI_CONE, AOI_SPOTS = 0, 1, 2, 3, 4
# The program takes cos(angle) on the device (CUDA's cosf, within 2 ulp of
# the exact value). Pairs whose cosine lies within this many ulp of the
# correctly rounded threshold may fall either way.
CONE_BAND_ULP = 4


def recip(value: float) -> F32:
    """1/value with both rounded to float32."""
    return F32(1.0) / F32(value)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), held as
    float32. NaN stays NaN."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = rounded.view(np.float32).copy()
    nan = np.isnan(x)
    out[nan] = x[nan]
    return out


def f32_to_i32(x: np.ndarray) -> np.ndarray:
    """Truncation to int32 with NaN -> 0 and saturation at the int32 range."""
    big = x >= 2147483648.0
    small = x < -2147483648.0
    with np.errstate(invalid="ignore"):
        inside = np.where(big | small | np.isnan(x), 0.0, x).astype(np.int32)
    return np.where(big, np.int32(2**31 - 1), np.where(small, np.int32(-(2**31)), inside))


def coord(p: np.ndarray, offset: float, size: float, count: int):
    with np.errstate(invalid="ignore"):
        f = np.floor((p - F32(offset)) * recip(size))
        nan = np.isnan(f)
        inside = ((f >= 0) & (f < count)) | nan
        idx = np.where(inside & ~nan, f, F32(0)).astype(np.int32)
    return idx, inside


def assign_cells(grid: dict, pos: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """f32[N,3] positions -> i32[N] cells, -1 for invalid or outside."""
    gx, in_x = coord(pos[:, 0], grid["offset_x"], grid["cell_w"], grid["cols"])
    gz, in_z = coord(pos[:, 2], grid["offset_z"], grid["cell_h"], grid["rows"])
    inside = in_x & in_z & valid
    return np.where(inside, gx + gz * np.int32(grid["cols"]), np.int32(-1)).astype(np.int32)


def handovers(prev: np.ndarray, cell: np.ndarray, max_rows: int):
    """(count, rows i32[k,3] of (slot, src, dst) in slot order for the first
    ``max_rows`` crossings, the next tick's baseline): a crossing beyond
    the row budget keeps its old cell, so it is found again."""
    mask = (prev >= 0) & (cell >= 0) & (prev != cell)
    slots = np.nonzero(mask)[0]
    count = slots.size
    shown = slots[:min(max_rows, prev.shape[0])]
    rows = np.stack([shown, prev[shown], cell[shown]], axis=1).astype(np.int64)
    committed = cell.copy()
    late = slots[shown.size:]
    committed[late] = prev[late]
    return count, rows, committed


def cell_counts(cell: np.ndarray, num_cells: int) -> np.ndarray:
    return np.bincount(cell[cell >= 0], minlength=num_cells).astype(np.int64)


def fanout_due(now_ms: int, last: np.ndarray, interval: np.ndarray, active: np.ndarray):
    """(due bool[S], advanced window starts): a due subscription's window
    moves by one interval, not to now."""
    nxt = (last + interval).astype(np.int32)
    due = active & (nxt <= np.int32(now_ms))
    return due, np.where(due, nxt, last).astype(np.int32)


def cell_centres(grid: dict, ids: np.ndarray):
    cols = int(grid["cols"])
    col = (ids % cols).astype(np.float32)
    row = (ids // cols).astype(np.float32)
    return ((col + F32(0.5)) * F32(grid["cell_w"]) + F32(grid["offset_x"]),
            (row + F32(0.5)) * F32(grid["cell_h"]) + F32(grid["offset_z"]))


def diagonal(grid: dict) -> float:
    return float((grid["cell_w"] ** 2 + grid["cell_h"] ** 2) ** 0.5)


def cos_threshold(angle: np.ndarray) -> np.ndarray:
    """cos(angle), correctly rounded to float32."""
    return np.cos(np.asarray(angle, np.float32).astype(np.float64)).astype(np.float32)


def cone_band(cos: np.ndarray):
    """(strict, loose) thresholds CONE_BAND_ULP ulp above and below."""
    hi = lo = np.asarray(cos, np.float32)
    for _ in range(CONE_BAND_ULP):
        hi = np.nextafter(hi, F32(np.inf))
        lo = np.nextafter(lo, F32(-np.inf))
    return hi, lo


def interest(grid: dict, kind, cx, cz, ex, ez, dx, dz, cos, spot_rows=None):
    """Interest of queries (arrays [Q]) in every cell: (strict bool[Q,C],
    loose bool[Q,C], dist i32[Q,C]). ``strict`` and ``loose`` differ only
    for cone queries, in the cells whose cosine lies inside the band of
    the threshold (``cone_band``); ``spot_rows`` i32[Q,C] is the spots
    table of those rows (-1 = no interest), or None."""
    c = int(grid["cols"]) * int(grid["rows"])
    ids = np.arange(c, dtype=np.int32)
    ccx, ccz = cell_centres(grid, ids)
    half_w = F32(grid["cell_w"] * 0.5)
    half_h = F32(grid["cell_h"] * 0.5)
    col = lambda a: np.asarray(a, np.float32)[:, None]  # noqa: E731
    ddx = col(cx) - ccx[None, :]
    ddz = col(cz) - ccz[None, :]
    adx = np.abs(ddx)
    adz = np.abs(ddz)
    gap_x = np.maximum(adx - half_w, F32(0))
    gap_z = np.maximum(adz - half_h, F32(0))
    rect = np.sqrt(gap_x * gap_x + gap_z * gap_z)
    centre = np.sqrt(ddx * ddx + ddz * ddz)
    radius = col(ex)
    sphere = rect <= radius
    box = (adx <= col(ex) + half_w) & (adz <= col(ez) + half_h)
    to_len = np.maximum(centre, F32(1e-9))
    dot = (-ddx) * col(dx) + (-ddz) * col(dz)
    cosine = dot / to_len
    apex = rect <= F32(0)
    hi, lo = cone_band(cos)
    in_strict = cosine >= np.asarray(hi, np.float32)[:, None]
    in_loose = cosine >= np.asarray(lo, np.float32)[:, None]
    k = np.asarray(kind)[:, None]
    geo = ((k == AOI_SPHERE) & sphere) | ((k == AOI_BOX) & box)
    near = rect <= radius
    strict = geo | ((k == AOI_CONE) & near & (in_strict | apex))
    loose = geo | ((k == AOI_CONE) & near & (in_loose | apex))
    with np.errstate(invalid="ignore", over="ignore"):
        dist = f32_to_i32(np.ceil(centre * recip(diagonal(grid))))
    dist = np.where(apex, np.int32(0), dist).astype(np.int32)
    if spot_rows is not None:
        spots = k == AOI_SPOTS
        hit = spot_rows >= 0
        strict = np.where(spots, hit, strict)
        loose = np.where(spots, hit, loose)
        dist = np.where(spots & hit, spot_rows, dist)
    return strict, loose, dist


def spots_row(grid: dict, spots_x, spots_z, dists) -> np.ndarray:
    """The cells a spots query targets: i32[C] of the damping distance,
    -1 where none. Each spot's cell is ``floor((x - offset) / size)`` in
    double precision; a spot outside the grid is skipped; where spots share
    a cell the last one's distance stands; a spot past the list of
    distances takes 0."""
    cols, rows = int(grid["cols"]), int(grid["rows"])
    out = np.full(cols * rows, -1, np.int32)
    for i, (x, z) in enumerate(zip(spots_x, spots_z)):
        cx = math.floor((x - grid["offset_x"]) / grid["cell_w"])
        cz = math.floor((z - grid["offset_z"]) / grid["cell_h"])
        if not (0 <= cx < cols and 0 <= cz < rows):
            continue
        out[cz * cols + cx] = min(int(dists[i]), 2**31 - 1) if i < len(dists) else 0
    return out
