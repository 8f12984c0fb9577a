"""Multi-device sharding of the spatial decision step (entity axis).

The port of ``channeld_tpu/parallel/mesh.py``. Entity slot arrays are
sharded over the mesh, the (small) query set and grid geometry are
replicated, and per-cell occupancy is combined with ``psum``: every
shard learns the global per-cell counts in one collective instead of
exchanging border entities.

The mesh is ``spmd.Mesh`` (an ordered list of devices, repeats allowed)
and ``shard_map`` is ``spmd.run_shards``, a loop over the shards with
each shard's device current (see ``spmd.py`` for why the port does not
use ``torch.distributed``). Each shard assigns its slots through K1
(``cuda_kernels.assign_and_count``) on its own device. The replicated
AOI and due decisions are computed once, on the first shard's device,
with the single-device functions (K2 through ``aoi_masks_cuda``); JAX
computes them once per shard, from the same replicated inputs, to the
same values.

A sharded array is a list of per-shard tensors, one per mesh position,
each on its shard's device; the steps also take a global tensor and
split it (``spmd.shard``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.cuda_kernels import aoi_masks_cuda, assign_and_count
from ..ops.spatial_ops import (
    QuerySet,
    compact_handovers,
    detect_handovers,
    fanout_due,
    packbits,
)
from ..utils.devices import mesh_devices
from . import spmd
from .spmd import Mesh

DATA_AXIS = "entities"
HOST_AXIS = "hosts"


def make_mesh(devices: Optional[list] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """A 1D mesh over ``devices`` (every CUDA card when None), in order;
    a device may appear more than once."""
    devices = devices if devices is not None else mesh_devices(torch.cuda.device_count())
    return Mesh(devices, (len(devices),), (axis_name,))


def make_mesh_2d(n_hosts: int, devices: Optional[list] = None) -> Mesh:
    """The (hosts, entities) mesh: ``devices`` row-major, ``n_hosts`` rows.
    Entity arrays shard over both axes (each host's devices own a
    contiguous slot range) and the occupancy psum reduces over both."""
    devices = devices if devices is not None else mesh_devices(torch.cuda.device_count())
    if n_hosts < 1 or len(devices) % n_hosts:
        raise ValueError(f"{len(devices)} devices do not split over {n_hosts} hosts")
    return Mesh(devices, (n_hosts, len(devices) // n_hosts), (HOST_AXIS, DATA_AXIS))


def mesh_from_config(n_devices: int, n_hosts: int = 1, device=None) -> Optional[Mesh]:
    """Mesh for the serving engine from config/flag values; None when
    n_devices is 0 (single-device step). ``device``: the engine's device
    kind (``cuda`` when None): ``n_devices`` shards on ``cpu``, or the
    first ``n_devices`` cards (ValueError when fewer are present)."""
    if not n_devices:
        return None
    devices = mesh_devices(int(n_devices), device)
    if n_hosts > 1:
        return make_mesh_2d(n_hosts, devices)
    return make_mesh(devices)


def entity_sharding(mesh: Mesh, capacity: int) -> list[range]:
    """Joint sharding over every mesh axis: the slot range each shard
    owns, in shard order (capacity must divide over the shards)."""
    if capacity % mesh.size:
        raise ValueError(f"{capacity} slots do not shard over {mesh.size} devices")
    size = capacity // mesh.size
    return [range(s * size, (s + 1) * size) for s in range(mesh.size)]


def replicated(mesh: Mesh) -> torch.device:
    """Where the port keeps a replicated value: the first shard's device."""
    return mesh.replica


def shift_rows(ho_rows: torch.Tensor, offset: int) -> torch.Tensor:
    """Local slot indices of handover rows -> global slots (rows < 0 stay
    -1)."""
    ho_rows = ho_rows.clone()
    ho_rows[:, 0] = torch.where(ho_rows[:, 0] >= 0, ho_rows[:, 0] + offset, -1)
    return ho_rows


def handover_plane(grid, mesh: Mesh, shard: int, positions, prev_cell, valid,
                   max_handovers_per_shard: int):
    """One shard's slot-local part of a step: cell assignment and
    occupancy (K1), crossings and their compaction, the committed
    baseline, rows shifted to global slots. Returns (cell_of,
    committed_prev, ho_count, ho_rows, counts)."""
    cell_of, counts = assign_and_count(grid, positions, valid)
    handover_mask = detect_handovers(prev_cell, cell_of)
    ho_count, ho_rows, reported = compact_handovers(
        handover_mask, prev_cell, cell_of, max_handovers_per_shard
    )
    # Crossings that overflowed this shard's row budget keep their old
    # cell as next tick's baseline so they are re-detected, not lost.
    committed_prev = torch.where(handover_mask & ~reported, prev_cell, cell_of)
    # Local slot indices -> global entity slots (row-major shard order).
    shard_index = mesh.shard_index(mesh.coords(shard))
    ho_rows = shift_rows(ho_rows, shard_index * positions.shape[0])
    return cell_of, committed_prev, ho_count, ho_rows, counts


def build_sharded_step(grid, mesh: Mesh, max_handovers_per_shard: int,
                       with_spots: bool = False):
    """The per-tick decision step sharded over ``mesh``.

    Entity arrays (positions/prev_cell/valid) are sharded over every mesh
    axis; queries and subscription state are replicated (on the first
    shard's device); outputs: cell_of and committed_prev sharded, handover
    counts i32[S] and rows i32[S, R, 3] gathered, cell counts and AOI
    masks replicated.

    ``with_spots=True`` adds the replicated [Q,C] spots dist table to the
    signature (see QuerySet.spot_dist) — build with it when any query
    uses SpotsAOI."""
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
        parts = spmd.run_shards(mesh, lambda s: handover_plane(
            grid, mesh, s, positions[s], prev_cell[s], valid[s], max_handovers_per_shard))
        cell_of, committed_prev, ho_counts, ho_rows, shard_counts = zip(*parts)
        with spmd.on_device(replica):
            # Global per-cell occupancy: the collective that replaces the
            # reference's cross-server interest border.
            counts = spmd.psum(shard_counts, replica)
            # Replicated decisions, computed once.
            interest, dist = aoi_masks_cuda(grid, queries)
            due, new_last = fanout_due(now_ms, last_ms, interval_ms, active)
            # Every shard's handover rows gathered, so the host reads one
            # array.
            all_counts = spmd.all_gather(ho_counts, replica)
            all_rows = spmd.all_gather(ho_rows, replica)
            due_packed = packbits(due)
        return (list(cell_of), list(committed_prev), all_counts, all_rows, counts,
                interest, dist, due, due_packed, new_last)

    step.with_spots = with_spots
    step.mesh = mesh
    return step


def check_spots(step_fn, queries: QuerySet, maker: str) -> None:
    if queries.spot_dist is not None and not step_fn.with_spots:
        raise ValueError(f"queries carry a spots table; {maker}(with_spots=True)")
    if queries.spot_dist is None and step_fn.with_spots:
        raise ValueError("step compiled with_spots=True but queries have no spots table")


def sharded_spatial_step(step_fn, positions, prev_cell, valid, queries: QuerySet,
                         sub_state, now_ms):
    last_ms, interval_ms, active = sub_state
    check_spots(step_fn, queries, "build_sharded_step")
    spot_args = (queries.spot_dist,) if step_fn.with_spots else ()
    (cell_of, committed_prev, ho_counts, ho_rows, counts, interest, dist,
     due, due_packed, new_last) = step_fn(
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
    }


def merge_handover_shards(ho_counts, ho_rows) -> "tuple[int, np.ndarray]":
    """Flatten per-shard gathered handover rows into one (count, rows[K,3])
    array in shard order, dropping unused row slots. Host-side numpy (a
    tensor argument is read to the host first)."""
    counts = _host(ho_counts).reshape(-1)
    rows = _host(ho_rows)
    rows = rows.reshape(counts.shape[0], -1, 3)
    per_shard = rows.shape[1]
    merged = [rows[i, : min(int(counts[i]), per_shard)] for i in range(len(counts))]
    flat = (np.concatenate(merged, axis=0) if merged
            else np.zeros((0, 3), np.int32))
    return int(flat.shape[0]), flat


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mesh_consume_blob(out: dict, mesh: Mesh) -> torch.Tensor:
    """A mesh tick's single host-consumption blob, on the first shard's
    device. Layout (i32):
      [0 : S]              per-shard handover counts
      [... : +S*R*3]       gathered handover rows [S, R, 3], row-major
      [... : +C]           cell counts
      [... : +ceil(D/32)]  due bitmask words (as in spatial_step's blob)
    and on the cells plane (``out`` has "undelivered"):
      [... : +S]           per-shard overflow
      [... : +ceil(N/32)]  the undelivered mask over all N slots, packed
                           like the due bits."""
    replica = mesh.replica
    with spmd.on_device(replica):
        parts = [out["handover_counts"].reshape(-1), out["handovers"].reshape(-1),
                 out["cell_counts"], _words(out["due_packed"])]
        if "undelivered" in out:
            parts.append(out["overflow"].reshape(-1))
            parts.append(_words(packbits(spmd.unshard(out["undelivered"], replica))))
        return torch.cat(parts)


def _words(packed: torch.Tensor) -> torch.Tensor:
    """u8 bytes zero-padded to whole little-endian int32 words."""
    pad = (-packed.shape[0]) % 4
    return torch.nn.functional.pad(packed, (0, pad)).view(torch.int32)


def parse_mesh_consume_blob(blob, n_shards: int, rows_per_shard: int, num_cells: int,
                            num_subs: int, num_slots: int = 0):
    """Host-side split of ``mesh_consume_blob`` (numpy). ``num_slots``: N
    on the cells plane, 0 otherwise. Returns ((count, rows i32[K,3],
    counts i32[C], due u8[D]), overflow, undelivered bool[N] or None),
    the rows merged in shard order by ``merge_handover_shards``."""
    blob = np.asarray(blob)
    at = n_shards + n_shards * rows_per_shard * 3
    count, rows = merge_handover_shards(blob[:n_shards], blob[n_shards:at])
    counts = blob[at:at + num_cells]
    at += num_cells
    due_end = at + -(-num_subs // 32)
    due = np.unpackbits(blob[at:due_end].view(np.uint8))[:num_subs]
    if not num_slots:
        return (count, rows, counts, due), 0, None
    overflow = int(blob[due_end:due_end + n_shards].sum())
    words = blob[due_end + n_shards:]
    undelivered = np.unpackbits(words.view(np.uint8))[:num_slots].astype(bool)
    return (count, rows, counts, due), overflow, undelivered
