"""The port's top-level entry points: one decision step and the multi-device dry run.

The port of the repository's ``__graft_entry__.py``, step for step:

- ``_example_inputs`` makes the same draws from ``np.random.default_rng(0)``
  in the same order, and returns the port's ``GridSpec`` and ``QuerySet``
  with tensors on the device; ``example_args_from_numpy`` turns the JAX
  entry's example arguments, as numpy arrays, into the port's tensors;
- ``entry`` returns ``(fn, example_args)``: ``fn`` is the port's
  ``spatial_step`` with 64 handover rows at ``now_ms`` 33, which on a card
  runs K1 (``cuda_kernels.assign_and_count``) and K2
  (``cuda_kernels.aoi_masks_cuda``);
- ``dryrun_multichip`` drives the serving ``SpatialEngine`` over an
  ``n_devices`` mesh under the three serving shardings (entities 1D,
  entities 2D for an even count, cells), checks every tick's decisions
  against the single-device engine, checks the cell-sharded all_to_all
  plane against the dense counts, prints the JAX entry's OK line and
  returns the decisions.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, and never falls back to the CPU or to fewer shards on its
own. The JAX entry first calls ``pin_cpu_if_virtual_devices``, which pins
JAX's backend to the CPU when XLA was told to fake host devices; that is a
concern of JAX's backend selection and has no counterpart here: the CPU
mesh is asked for with ``device="cpu"`` (``n`` shards on ``cpu``), and a
mesh that repeats one card is asked for with an explicit ``devices`` list.

    python -c "from channeld_tpu_torch import graft_entry as g; g.dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.engine import SpatialEngine
from .ops.spatial_ops import GridSpec, QuerySet, assign_cells, cell_counts, spatial_step
from .parallel.mesh import make_mesh, make_mesh_2d
from .parallel.spatial_alltoall import build_cell_sharded_step, make_space_mesh
from .utils.devices import mesh_devices, resolve_device

MAX_HANDOVERS = 64
NOW_MS = 33
DRY_RUN_TICKS = (30, 60, 120)
DRY_RUN_GRID = GridSpec(offset_x=0.0, offset_z=0.0, cell_w=100.0, cell_h=100.0, cols=8, rows=8)


def _example_arrays(n: int, q: int, s: int, cols: int) -> tuple:
    """The JAX entry's example arguments as numpy arrays, drawn in its order."""
    rng = np.random.default_rng(0)
    positions = rng.uniform(0, 100 * cols, size=(n, 3)).astype(np.float32)
    center = rng.uniform(0, 800, size=(q, 2)).astype(np.float32)
    return (positions, np.full(n, -1, np.int32), np.ones(n, bool),
            np.ones(q, np.int32),  # spheres
            center, np.full((q, 2), 150.0, np.float32),
            np.tile(np.array([[1.0, 0.0]], np.float32), (q, 1)), np.zeros(q, np.float32),
            np.zeros(s, np.int32), np.full(s, 50, np.int32), np.ones(s, bool),
            np.int32(NOW_MS))


def example_args_from_numpy(args, device=None) -> tuple:
    """The twelve arguments of an entry's ``fn`` (positions, prev_cell,
    valid, the five query fields, the three subscription fields, now_ms)
    from numpy arrays, such as ``np.asarray`` of the JAX entry's example
    arguments: eleven tensors on ``device`` and ``now_ms`` as an int."""
    dev = resolve_device(device)
    *arrays, now_ms = args
    return (*(torch.from_numpy(np.array(a)).to(dev) for a in arrays), int(now_ms))


def _example_inputs(n=256, q=16, s=64, cols=8, rows=8, device=None):
    """(grid, positions, prev_cell, valid, queries, sub_state) of the JAX
    entry's example, as the port's types on ``device``."""
    grid = GridSpec(offset_x=0.0, offset_z=0.0, cell_w=100.0, cell_h=100.0,
                    cols=cols, rows=rows)
    args = example_args_from_numpy(_example_arrays(n, q, s, cols), device)
    positions, prev_cell, valid = args[:3]
    return grid, positions, prev_cell, valid, QuerySet(*args[3:8]), tuple(args[8:11])


def entry(device=None, **sizes):
    """Returns (fn, example_args): one forward decision step and its
    example arguments on ``device``. ``sizes`` (n, q, s, cols, rows) go to
    ``_example_inputs``; the defaults are the JAX entry's."""
    grid, positions, prev_cell, valid, queries, sub_state = _example_inputs(device=device,
                                                                           **sizes)

    def fn(positions, prev_cell, valid, q_kind, q_center, q_extent, q_dir,
           q_angle, last_ms, interval_ms, active, now_ms):
        return spatial_step(
            grid, positions, prev_cell, valid,
            QuerySet(q_kind, q_center, q_extent, q_dir, q_angle),
            (last_ms, interval_ms, active), MAX_HANDOVERS, int(now_ms),
        )

    example_args = (positions, prev_cell, valid, *queries[:5], *sub_state, NOW_MS)
    return fn, example_args


def _host(x) -> np.ndarray:
    """A host copy of a tensor (or of any array numpy reads)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def drive_engine(eng, n_entities: int) -> list:
    """The dry run's serving flow on a fresh engine of 8x8 cells: entity
    churn, a sphere, a box and a spots query, 8 subscriptions, three ticks.
    Returns each tick's gateway-visible decisions. ``eng`` is any engine
    with the serving engine's methods (the JAX package's too)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 800, size=(n_entities, 3)).astype(np.float32)
    for eid in range(n_entities):
        eng.add_entity(500 + eid, *pts[eid])
    eng.set_query(1, 1, (400.0, 400.0), (200.0, 0.0))  # sphere
    eng.set_query(2, 2, (100.0, 100.0), (150.0, 150.0))  # box
    eng.set_spots_query(3, [(50.0, 50.0), (750.0, 750.0)], [1, 2])
    for _ in range(8):
        eng.add_subscription(interval_ms=50)
    outs = []
    for now in DRY_RUN_TICKS:
        for eid in range(0, n_entities, 3):
            pts[eid, 0] = (pts[eid, 0] + 230.0) % 800.0
            eng.update_entity(500 + eid, *pts[eid])
        out = eng.tick(now_ms=now)
        outs.append(dict(
            cell_counts=_host(out["cell_counts"]),
            handovers=sorted(eng.handover_list(out)),
            interest_1=eng.interested_cells(out, 1),
            interest_3=eng.interested_cells(out, 3),
            due=_host(out["due"]),
        ))
    return outs


def first_difference(got: dict, want: dict) -> Optional[str]:
    """The first field in which two ticks' decisions differ, or None."""
    for key in want:
        a, b = got[key], want[key]
        same = np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b
        if not same:
            return key
    return None


def _require(held: bool, what: str) -> None:
    if not held:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device=None, devices=None) -> dict:
    """Drive the serving engine over an ``n_devices`` mesh: the
    ``SpatialEngine`` (what the GPU controller and the sidecar serve from)
    with its entity slot arrays sharded over the mesh, and check that the
    gateway-visible results equal the single-device engine's exactly.

    ``devices``: the mesh's devices, in order (a list may repeat one
    card); by default ``utils.devices.mesh_devices(n_devices, device)``:
    ``n_devices`` distinct cards (ValueError when fewer are present) or,
    with ``device="cpu"``, ``n_devices`` CPU shards. Raises AssertionError
    when a check fails. Returns the single-device engine's decisions per
    tick (``single``), each sharding's (``meshes``: [(label, ticks)]), the
    cell-sharded plane's counts beside the dense ones (``cells_plane``),
    the handovers counted over the meshes and the printed line."""
    if devices is None:
        devices = mesh_devices(n_devices, device)
    else:
        devices = [torch.device(d) for d in devices][:n_devices]
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        if device is not None and resolve_device(device).type != devices[0].type:
            raise ValueError(f"device {device} is not of the devices' kind ({devices[0]})")

    def drive(mesh, sharding="entities"):
        eng = SpatialEngine(DRY_RUN_GRID, entity_capacity=16 * n_devices,
                            query_capacity=8, sub_capacity=16,
                            max_handovers=256, mesh=mesh, sharding=sharding,
                            device=devices[0] if mesh is None else None)
        return drive_engine(eng, 12 * n_devices)

    base = drive(mesh=None)
    ho_total = 0
    # Serving shardings: entity-sharded 1D, entity-sharded 2D (hosts x
    # entities), and the cell-sharded plane as a serving backend (Config
    # {"Sharding": "cells"}: all_to_all redistribution, column-block AOI,
    # ring halos).
    meshes = [(make_mesh(devices), "entities", "entities"),
              (make_mesh(devices), "cells", "cells")]
    if n_devices % 2 == 0:
        meshes.insert(1, (make_mesh_2d(2, devices), "entities", "entities-2d"))
    runs = []
    for mesh, sharding, label in meshes:
        outs = drive(mesh, sharding)
        for t, (got, want) in enumerate(zip(outs, base)):
            where = first_difference(got, want)
            _require(where is None, f"{label} tick {t}: {where} differs from the single device")
            ho_total += len(got["handovers"])
        runs.append((label, outs))
    # The cell-sharded plane: space partitioned over the mesh, all_to_all
    # entity redistribution and the ring exchange of the interest border.
    sgrid = GridSpec(offset_x=0.0, offset_z=0.0, cell_w=100.0, cell_h=100.0,
                     cols=4, rows=n_devices)
    sstep = build_cell_sharded_step(sgrid, make_space_mesh(devices), bucket=64)
    rng = np.random.default_rng(3)
    spts = rng.uniform(0, [400, 10, 100 * n_devices],
                       size=(16 * n_devices, 3)).astype(np.float32)
    sids = np.arange(16 * n_devices, dtype=np.int32)
    pos = torch.from_numpy(spts).to(devices[0])
    valid = torch.ones(16 * n_devices, dtype=torch.bool, device=devices[0])
    _, _, _, counts, _, _, _, overflow = sstep(pos, valid, torch.from_numpy(sids).to(devices[0]))
    dense = cell_counts(assign_cells(sgrid, pos, valid), sgrid.num_cells)
    cells_plane = dict(counts=_host(counts).reshape(-1), dense=_host(dense),
                       overflow=int(_host(overflow).sum()))
    _require(np.array_equal(cells_plane["counts"], cells_plane["dense"]),
             "the cell-sharded plane's counts differ from the dense counts")
    _require(cells_plane["overflow"] == 0, f"the cell-sharded plane overflowed "
                                           f"{cells_plane['overflow']} entities")

    line = (f"dryrun_multichip OK: serving engine on {n_devices} devices, "
            f"{12 * n_devices} entities, {ho_total} handovers, decisions "
            f"identical to single-device across "
            f"{[s for _, s, _ in meshes]} serving shardings; cell-sharded "
            f"all_to_all + ring-halo plane matches dense")
    print(line)
    return dict(single=base, meshes=runs, cells_plane=cells_plane, handovers=ho_total,
                line=line)
