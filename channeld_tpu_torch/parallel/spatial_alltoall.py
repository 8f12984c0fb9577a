"""Cell-sharded spatial decision plane: space partitioned over devices.

The port of ``channeld_tpu/parallel/spatial_alltoall.py``.
``parallel/mesh.py`` shards the ENTITY axis (every device sees every
cell); this module shards SPACE itself — each shard owns a contiguous
block of the grid, as the reference gives each spatial server an
authority block of cells with a subscribed interest border
(ref: spatial.go:89-124, :481-590):

- **all-to-all redistribution**: entities land on whichever shard
  ingested them; each tick computes their cell (K1 on the ingesting
  shard), packs them into fixed-capacity per-destination buckets, and
  one ``all_to_all`` delivers every entity to the shard that OWNS its
  cell block. Bucket overflow is never silent: the per-slot
  ``undelivered`` mask names exactly which ingest slots did not fit.
- **ring halo exchange**: per-cell occupancy of the first/last owned
  grid rows moves to the ring neighbours (``ppermute``), each shard's
  interest border.

Buckets are packed as the JAX step packs them — each destination's
slots in ascending slot order, the first ``bucket`` of them, the rest
-1 — but by one rank scatter per shard (each slot's rank among the
slots bound for its destination, from a cumulative count per
destination) instead of ``nonzero(size=bucket)`` per destination:
torch's ``nonzero`` has no static size and would wait for the host
``S`` times per shard per tick. The rows are the same.

The mesh is ``spmd.Mesh`` and its collectives are ``spmd``'s (see
``spmd.py``); every step's outputs are equal to the JAX plane's on the
same inputs (tests/test_torch_alltoall.py).
"""

from __future__ import annotations

import torch

from ..ops.cuda_kernels import aoi_block_cuda, assign_and_count
from ..ops.spatial_ops import QuerySet, fanout_due, num_cells, packbits
from . import spmd
from .mesh import check_spots, handover_plane, make_mesh
from .spmd import Mesh

AXIS = "space"


def make_space_mesh(devices=None) -> Mesh:
    return make_mesh(devices, axis_name=AXIS)


def rows_per_shard(grid, n_shards: int) -> int:
    if grid.rows % n_shards != 0:
        raise ValueError(
            f"grid rows {grid.rows} must divide evenly over {n_shards} shards"
        )
    return grid.rows // n_shards


def pack_buckets(dest: torch.Tensor, n_shards: int, bucket: int, columns):
    """Per-destination buckets of one ingest shard.

    ``dest`` i32[n]: each slot's owner shard (-1 = none). ``columns``:
    [(values [n, ...], fill)] to pack. Returns ([each column packed to
    [S, bucket, ...]], delivered bool[n]): destination ``d``'s row ``k``
    holds its ``k``-th slot in slot order while ``k`` is below both its
    slot count and ``bucket``, else the column's fill."""
    n, dev = dest.shape[0], dest.device
    lanes = torch.arange(n_shards, dtype=torch.int32, device=dev)
    # bool[S, n]: the scan runs along the contiguous last dim (a scan
    # along dim 0 of [n, S] runs S-wide and is ~100x slower on the card).
    bound = lanes[:, None] == dest[None, :]
    # Each slot's rank among the slots bound for its destination.
    rank = torch.cumsum(bound, 1, dtype=torch.int32) - 1
    own = rank.gather(0, torch.clamp(dest, min=0).to(torch.int64)[None, :])[0]
    delivered = (dest >= 0) & (own < bucket)
    # Each delivered slot's index scattered to (dest, rank); the rest
    # write a discard lane, sliced off.
    target = torch.where(delivered, dest * bucket + own, n_shards * bucket).to(torch.int64)
    idx = torch.zeros(n_shards * bucket + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, target, torch.arange(n, dtype=torch.int32, device=dev))
    idx = idx[: n_shards * bucket].reshape(n_shards, bucket).to(torch.int64)
    fitted = torch.clamp(bound.sum(1, dtype=torch.int32), max=bucket)  # [S]
    row_valid = torch.arange(bucket, device=dev)[None, :] < fitted[:, None]
    packed = []
    for values, fill in columns:
        rows = values[idx]
        mask = row_valid.reshape(row_valid.shape + (1,) * (rows.dim() - 2))
        packed.append(torch.where(mask, rows, fill).to(values.dtype))
    return packed, delivered


def _redistribute(mesh: Mesh, dest, columns, bucket: int):
    """Bucket packing on every shard, then the all_to_all of each column.
    ``columns[s]``: shard ``s``'s [(values, fill)]. Returns (received
    columns, each a per-shard list of [S * bucket, ...], undelivered
    per shard, overflow i32[S] per shard)."""
    def pack(s):
        packed, delivered = pack_buckets(dest[s], mesh.size, bucket, columns[s])
        undelivered = (dest[s] >= 0) & ~delivered
        return packed, undelivered, undelivered.sum(dtype=torch.int32)

    parts = spmd.run_shards(mesh, pack)
    received = []
    for k in range(len(columns[0])):
        recv = spmd.all_to_all(mesh, [p[0][k] for p in parts])
        received.append([r.reshape((-1,) + tuple(r.shape[2:])) for r in recv])
    return received, [p[1] for p in parts], [p[2] for p in parts]


def _block_counts(owned_cells: torch.Tensor, block_start: int, cells_blk: int) -> torch.Tensor:
    """Owned-block occupancy from what the owner received."""
    present = owned_cells >= 0
    local = torch.where(present, owned_cells - block_start, 0).to(torch.int64)
    counts = torch.zeros(cells_blk, dtype=torch.int32, device=owned_cells.device)
    return counts.index_add_(0, local, present.to(torch.int32))


def build_cell_sharded_step(grid, mesh: Mesh, bucket: int):
    """The cell-sharded ingest tick.

    Inputs (sharded over AXIS): positions f32[N,3], valid bool[N],
    entity_ids i32[N] — N is the per-ingest-shard capacity x n_shards.

    Returns, stacked over the shards on the first shard's device (JAX
    leaves them sharded; leading dim = n_shards):
      owned_ids   i32[S, bucket*S]  entity ids now resident on their
                                    owner shard (-1 = empty slot)
      owned_cells i32[S, bucket*S]  the owned entities' global cell ids
      owned_xyz   f32[S, bucket*S, 3]  their positions
      counts      i32[S, rows_blk*cols]   occupancy of the OWNED block
      halo_lo     i32[S, cols]  occupancy of the previous shard's LAST
                                owned row (the south interest border)
      halo_hi     i32[S, cols]  occupancy of the next shard's FIRST
                                owned row (the north interest border)
      undelivered bool[S, n_local]  ingest slots whose destination
                                bucket was full this tick
      overflow    i32[S]        sum of undelivered (diagnostic)
    """
    n_shards = mesh.size
    rows_blk = rows_per_shard(grid, n_shards)
    cells_blk = rows_blk * grid.cols
    cols = int(grid.cols)

    def step(positions, valid, entity_ids):
        positions, valid, entity_ids = (spmd.shard(mesh, a) for a in (positions, valid, entity_ids))

        def assign(s):
            cell_of, _ = assign_and_count(grid, positions[s], valid[s])  # global cell ids
            row = torch.div(cell_of, cols, rounding_mode="floor")
            dest = torch.where(cell_of >= 0, torch.div(row, rows_blk, rounding_mode="floor"), -1)
            return cell_of, dest.to(torch.int32)

        cell_of, dest = zip(*spmd.run_shards(mesh, assign))
        columns = [[(entity_ids[s], -1), (cell_of[s], -1), (positions[s], 0.0)]
                   for s in range(n_shards)]
        (owned_ids, owned_cells, owned_xyz), undelivered, overflow = _redistribute(
            mesh, dest, columns, bucket)
        counts = spmd.run_shards(mesh, lambda s: _block_counts(
            owned_cells[s], s * cells_blk, cells_blk))
        # Ring halo: each shard's last owned row moves north (to s+1), its
        # first owned row south (to s-1); the world's edges get zeros.
        halo_lo = spmd.ppermute(mesh, [c[-cols:] for c in counts], 1)
        halo_hi = spmd.ppermute(mesh, [c[:cols] for c in counts], -1)
        halo_lo[0] = torch.zeros_like(halo_lo[0])
        halo_hi[-1] = torch.zeros_like(halo_hi[-1])
        replica = mesh.replica
        return tuple(spmd.all_gather(x, replica) for x in (
            owned_ids, owned_cells, owned_xyz, counts, halo_lo, halo_hi,
            undelivered, overflow))

    step.mesh = mesh
    return step


def cells_per_shard(grid, n_shards: int) -> int:
    """Owned-block size for the serving step: contiguous cell ranges,
    padded so any grid divides over any shard count (cell range ==
    row block whenever rows % n_shards == 0)."""
    return -(-num_cells(grid) // n_shards)


def build_cell_serving_step(grid, mesh: Mesh, bucket: int,
                            max_handovers_per_shard: int,
                            with_spots: bool = False):
    """The cell-sharded plane as a SERVING backend: the same result
    contract as parallel.mesh.build_sharded_step, with space itself
    partitioned —

    - each shard OWNS a contiguous block of ``cells_per_shard`` cells;
    - per-tick (global slot, cell) pairs are bucket-packed per owner and
      delivered with ONE all_to_all; the owner counts its block's
      occupancy from what it received (K1's histogram of the ingest
      shard is not used, as in JAX);
    - the [Q, C] AOI planes are computed block-wise, each shard K2 over
      its own cell ids (``cell_base`` = shard · cells_blk; the last block
      may run past the grid into padding ids), and gathered;
    - bucket overflow is never silent: ``undelivered`` (per shard,
      bool[n_local]) marks exactly the entities whose owner bucket was
      full; they stay in the ingest arrays and are re-offered next tick,
      and their occupancy is missing from this tick's counts.
      ``overflow`` carries the per-shard sums for the controller's shed
      metric.

    Handover detection/compaction and the fan-out due scan are
    slot-local / replicated exactly as in the entity-sharded step.

    Inputs: entity arrays slot-sharded over the mesh's (single) axis;
    queries + sub state replicated on the first shard's device."""
    if len(mesh.axis_names) != 1:
        raise ValueError(
            "cells sharding partitions space over one axis; got mesh axes "
            f"{mesh.axis_names} — use a 1D mesh (make_mesh)"
        )
    n_shards = mesh.size
    cells_blk = cells_per_shard(grid, n_shards)
    replica = mesh.replica

    def step(positions, prev_cell, valid, q_kind, q_center, q_extent,
             q_dir, q_angle, *rest):
        if with_spots:
            spot_dist, last_ms, interval_ms, active, now_ms = rest
        else:
            spot_dist = None
            last_ms, interval_ms, active, now_ms = rest
        queries = QuerySet(q_kind, q_center, q_extent, q_dir, q_angle, spot_dist)
        positions, prev_cell, valid = (spmd.shard(mesh, a) for a in (positions, prev_cell, valid))
        shard_size = positions[0].shape[0]

        def slots(s):
            # Handover plane: slot-local, identical to the entity-sharded
            # step (K1's counts are dropped).
            cell_of, committed, ho_count, ho_rows, _ = handover_plane(
                grid, mesh, s, positions[s], prev_cell[s], valid[s],
                max_handovers_per_shard)
            dest = torch.where(cell_of >= 0, torch.div(cell_of, cells_blk, rounding_mode="floor"),
                               -1).to(torch.int32)
            global_slots = torch.arange(s * shard_size, (s + 1) * shard_size,
                                        dtype=torch.int32, device=cell_of.device)
            return cell_of, committed, ho_count, ho_rows, dest, global_slots

        cell_of, committed_prev, ho_counts, ho_rows, dest, global_slots = zip(
            *spmd.run_shards(mesh, slots))
        columns = [[(global_slots[s], -1), (cell_of[s], -1)] for s in range(n_shards)]
        (owned_ids, owned_cells), undelivered, overflow = _redistribute(
            mesh, dest, columns, bucket)

        def block(s):
            blk_counts = _block_counts(owned_cells[s], s * cells_blk, cells_blk)
            dev = mesh.devices[s]
            q = QuerySet(*(t.to(dev) for t in queries[:5]), None)
            spot_slice = None
            if spot_dist is not None:
                # The table arrives padded to cells_blk * n_shards columns
                # (see cell_serving_spatial_step), so the last block's
                # slice is in range and aligned with its cell ids.
                spot_slice = spot_dist[:, s * cells_blk:(s + 1) * cells_blk].to(dev)
            hit, dist = aoi_block_cuda(grid, q, s * cells_blk, cells_blk, spot_slice)
            return blk_counts, hit, dist

        blk_counts, blk_hit, blk_dist = zip(*spmd.run_shards(mesh, block))
        c = num_cells(grid)
        with spmd.on_device(replica):
            all_counts = spmd.all_gather(ho_counts, replica)
            all_rows = spmd.all_gather(ho_rows, replica)
            counts = spmd.all_gather(blk_counts, replica).reshape(-1)[:c]
            interest = spmd.all_gather(blk_hit, replica, dim=1)  # [Q, S, blk]
            dist = spmd.all_gather(blk_dist, replica, dim=1)
            interest = interest.reshape(interest.shape[0], -1)[:, :c]
            dist = dist.reshape(dist.shape[0], -1)[:, :c]
            # Fan-out due: replicated, computed once.
            due, new_last = fanout_due(now_ms, last_ms, interval_ms, active)
            due_packed = packbits(due)
            overflow = spmd.all_gather(overflow, replica)
            owned_ids = spmd.all_gather(owned_ids, replica)
        return (list(cell_of), list(committed_prev), all_counts, all_rows, counts,
                interest, dist, due, due_packed, new_last, list(undelivered),
                overflow, owned_ids)

    step.with_spots = with_spots
    step.bucket = bucket
    step.cells_blk = cells_blk
    step.n_shards = n_shards
    step.mesh = mesh
    return step


def cell_serving_spatial_step(step_fn, positions, prev_cell, valid,
                              queries: QuerySet, sub_state, now_ms):
    """Drive a build_cell_serving_step function; returns the engine's
    normalized tick-result dict (parallel.mesh.sharded_spatial_step's
    contract plus the cells-plane extras)."""
    last_ms, interval_ms, active = sub_state
    check_spots(step_fn, queries, "build_cell_serving_step")
    spot_args = ()
    if step_fn.with_spots:
        # Pad to the sharded cell space (cells_blk * n_shards columns, -1 =
        # no interest) so every shard's block slice is in range.
        c_pad = step_fn.cells_blk * step_fn.n_shards
        spot = queries.spot_dist
        if spot.shape[1] < c_pad:
            spot = torch.nn.functional.pad(spot, (0, c_pad - spot.shape[1]), value=-1)
        spot_args = (spot,)
    (cell_of, committed_prev, ho_counts, ho_rows, counts, interest, dist,
     due, due_packed, new_last, undelivered, overflow, owned_ids) = step_fn(
        positions, prev_cell, valid,
        queries.kind, queries.center, queries.extent, queries.direction,
        queries.angle, *spot_args, last_ms, interval_ms, active, int(now_ms),
    )
    return {
        "cell_of": cell_of,
        "committed_prev": committed_prev,
        "handover_counts": ho_counts,
        "handovers": ho_rows,
        "cell_counts": counts,
        "interest": interest,
        "dist": dist,
        "due": due,
        "due_packed": due_packed,
        "new_last_fanout_ms": new_last,
        "undelivered": undelivered,
        "overflow": overflow,
        "owned_ids": owned_ids,
    }
