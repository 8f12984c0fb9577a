"""channeld_tpu_torch.parallel.spatial_alltoall against the JAX package.

The port's cell-sharded planes run on eight shards on ``cpu``, the JAX
package's on its 8 virtual CPU devices, on the same seeded inputs. The
seven cases of tests/test_spatial_alltoall.py, each held exactly against
the JAX plane (every int and bool output: owned ids/cells/positions,
counts, halos, undelivered, overflow, handovers, committed baseline,
due, interest, dist) and, where the JAX case compares with the dense
single-device step, the port's plane against the port's own
``spatial_step`` too, exactly.

F6: with the cell ids a runtime value (they come from ``axis_index``),
XLA:CPU contracts the cell centre's ``(col + 0.5) * w + offset`` into
one FMA. On grids whose centres are exact in float32 that changes
nothing; on 11x5 cells of 37.3 x 61.1 m it moves pairs, and
``test_cells_plane_differs_from_jax_only_by_the_fused_cell_centre``
counts them and shows that recomputing the centres fused gives JAX's
planes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from channeld_tpu.ops import spatial_ops as J
from channeld_tpu.parallel import spatial_alltoall as JA
from channeld_tpu_torch.ops import cuda_kernels as K
from channeld_tpu_torch.ops import spatial_ops as T
from channeld_tpu_torch.parallel import spatial_alltoall as TA
from channeld_tpu_torch.parallel.mesh import merge_handover_shards

from test_torch_mesh import CPU8, assert_outputs_equal, host

GRID = J.GridSpec(offset_x=0.0, offset_z=0.0, cell_w=100.0, cell_h=100.0,
                  cols=4, rows=8)  # 8 rows over 8 shards -> 1 row each
GRID_6x4 = J.GridSpec(0.0, 0.0, 100.0, 100.0, 6, 4)  # 24 cells: padded blocks
GRID_5x5 = J.GridSpec(0.0, 0.0, 100.0, 100.0, 5, 5)  # 25 cells: a partial last block
GRID_ODD = J.GridSpec(-317.5, -123.25, 37.3, 61.1, 11, 5)


def meshes():
    return JA.make_space_mesh(), TA.make_space_mesh(CPU8)


def make_world(n=512, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, [400, 100, 800], size=(n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.05
    ids = np.arange(1000, 1000 + n, dtype=np.int32)
    return pts, valid, ids


def ingest_both(pts, valid, ids, bucket):
    jm, pm = meshes()
    jax_out = JA.build_cell_sharded_step(GRID, jm, bucket)(*map(jnp.asarray, (pts, valid, ids)))
    port_out = TA.build_cell_sharded_step(GRID, pm, bucket)(*map(torch.tensor, (pts, valid, ids)))
    for a, b in zip(jax_out, port_out):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    return [b.numpy() for b in port_out]


def test_cell_sharded_step_matches_dense():
    """Ingest plane with halos: equal to JAX on every output; occupancy,
    membership and halos equal to the dense computation."""
    pts, valid, ids = make_world()
    (owned_ids, owned_cells, owned_xyz, counts, halo_lo, halo_hi, undelivered,
     overflow) = ingest_both(pts, valid, ids, 256)
    assert int(overflow.sum()) == 0 and not undelivered.any()
    dense_cells = T.assign_cells(GRID, torch.tensor(pts), torch.tensor(valid))
    dense_counts = T.cell_counts(dense_cells, GRID.num_cells).numpy()
    dense_cells = dense_cells.numpy()
    assert np.array_equal(counts.reshape(-1), dense_counts)
    got = {}
    for shard in range(8):
        for k, (eid, cell) in enumerate(zip(owned_ids[shard], owned_cells[shard])):
            if eid >= 0:
                assert eid not in got, "entity delivered twice"
                got[eid] = (shard, cell)
                assert np.array_equal(owned_xyz[shard, k], pts[eid - 1000])
    for i, eid in enumerate(ids):
        cell = dense_cells[i]
        if cell < 0:
            assert eid not in got
            continue
        assert got[eid] == ((cell // GRID.cols) // TA.rows_per_shard(GRID, 8), cell)
    for s in range(8):
        lo = counts[s - 1][-GRID.cols:] if s > 0 else np.zeros(GRID.cols)
        hi = counts[s + 1][: GRID.cols] if s < 7 else np.zeros(GRID.cols)
        assert np.array_equal(halo_lo[s], lo) and np.array_equal(halo_hi[s], hi)


def test_cell_sharded_overflow_reported_not_dropped():
    """Everyone in row 0 with buckets of 4: the excess is reported, equal
    to JAX, never lost."""
    n = 512
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = 50.0
    pts[:, 2] = 50.0
    ids = np.arange(n, dtype=np.int32)
    owned_ids, _, _, counts, _, _, undelivered, overflow = ingest_both(
        pts, np.ones(n, bool), ids, 4)
    delivered = int((owned_ids >= 0).sum())
    assert delivered == 4 * 8
    assert int(overflow.sum()) == n - delivered == int(undelivered.sum())
    assert int(counts.sum()) == delivered
    und = undelivered.reshape(-1)
    delivered_ids = set(owned_ids[owned_ids >= 0].tolist())
    assert delivered_ids.isdisjoint(set(ids[und].tolist()))
    assert delivered_ids | set(ids[und].tolist()) == set(ids.tolist())


# ---- the serving step (engine backend, Config {"Sharding": "cells"}) ----


def serving_world(n=64, q=8, s=32, seed=7):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50, 650, (n, 3)).astype(np.float32)
    prev = rng.integers(-1, 24, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    qs = [rng.integers(0, 4, q).astype(np.int32),
          rng.uniform(0, 600, (q, 2)).astype(np.float32),
          rng.uniform(50, 250, (q, 2)).astype(np.float32),
          np.tile(np.array([[1.0, 0.0]], np.float32), (q, 1)),
          np.full(q, 0.6, np.float32)]
    subs = (rng.integers(0, 100, s).astype(np.int32),
            rng.choice([20, 50, 100], s).astype(np.int32), rng.random(s) < 0.9)
    return pos, prev, valid, qs, subs


def serve_both(grid, pos, prev, valid, qs, subs, bucket=8, per_shard=8, spot=None, now=120):
    """The JAX and the port serving steps on the same inputs; every output
    equal. Returns the port's result dict."""
    jm, pm = meshes()
    with_spots = spot is not None
    jq = J.QuerySet(*map(jnp.asarray, qs), None if spot is None else jnp.asarray(spot))
    pq = T.QuerySet(*map(torch.tensor, qs), None if spot is None else torch.tensor(spot))
    jax_out = JA.cell_serving_spatial_step(
        JA.build_cell_serving_step(grid, jm, bucket, per_shard, with_spots),
        *map(jnp.asarray, (pos, prev, valid)), jq, tuple(map(jnp.asarray, subs)), now)
    port_out = TA.cell_serving_spatial_step(
        TA.build_cell_serving_step(grid, pm, bucket, per_shard, with_spots),
        *map(torch.tensor, (pos, prev, valid)), pq, tuple(map(torch.tensor, subs)), now)
    assert_outputs_equal(jax_out, port_out)
    return port_out, pq


def dense_step(grid, pos, prev, valid, pq, subs, now=120):
    return T.spatial_step(grid, *map(torch.tensor, (pos, prev, valid)), pq,
                          tuple(map(torch.tensor, subs)), 64, now)


def assert_equals_dense(out, dense) -> None:
    for key in ("cell_of", "committed_prev", "cell_counts", "interest", "dist", "due",
                "new_last_fanout_ms"):
        np.testing.assert_array_equal(host(out[key]), dense[key].numpy(), err_msg=key)
    count, rows = merge_handover_shards(out["handover_counts"], out["handovers"])
    assert count == int(dense["handover_count"])
    assert rows.tolist() == dense["handovers"].numpy()[:count].tolist()


def test_cell_serving_step_matches_dense():
    """The full serving contract on a 6x4 grid whose 24 cells do not
    divide into row blocks over 8 shards: equal to JAX, and equal to the
    port's dense single-device step (interest and dist everywhere)."""
    pos, prev, valid, qs, subs = serving_world()
    out, pq = serve_both(GRID_6x4, pos, prev, valid, qs, subs)
    assert_equals_dense(out, dense_step(GRID_6x4, pos, prev, valid, pq, subs))
    assert not host(out["undelivered"]).any() and int(out["overflow"].sum()) == 0
    assert out["interest"].any()


@pytest.mark.parametrize("grid,cells", [(GRID_6x4, [2, 11, 17]), (GRID_5x5, [3, 11, 24])],
                         ids=["spots", "partial-last-block"])
def test_cell_serving_step_spots_overlay(grid, cells):
    """Spots queries ride the sliced [Q, block] table through the
    column-block AOI; on 5x5 (blocks of 4, shard 6 owns cell 24 and
    shard 7 only padding) the last partial block's slice must not
    misalign: equal to JAX and to the dense overlay."""
    pos, prev, valid, qs, subs = serving_world()
    spot = np.full((qs[0].shape[0], grid.num_cells), -1, np.int32)
    spot[0, cells] = [0, 3, 1]
    qs[0][0] = T.AOI_SPOTS
    out, pq = serve_both(grid, pos, prev, valid, qs, subs, spot=spot)
    assert_equals_dense(out, dense_step(grid, pos, prev, valid, pq, subs))
    assert out["interest"][0, cells[-1]], "border-cell spot lost"


def test_cell_serving_overflow_reoffers_next_tick():
    """Bucket overflow marks undelivered (occupancy short by exactly that
    many), equal to JAX; the next tick, with the hotspot dispersed,
    delivers every one of them."""
    n = 64
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = 50.0
    pos[:, 2] = 50.0  # everyone in cell 0 -> shard 0
    prev = np.full(n, -1, np.int32)
    valid = np.ones(n, bool)
    _, _, _, qs, subs = serving_world()
    out, _ = serve_both(GRID, pos, prev, valid, qs, subs, bucket=2, per_shard=16)
    und = host(out["undelivered"])
    assert int(und.sum()) == n - 2 * 8 == int(out["overflow"].sum())
    assert int(out["cell_counts"][0]) == 2 * 8
    assert sorted(set(out["owned_ids"][0].tolist()) - {-1}) == sorted(
        s * 8 + k for s in range(8) for k in range(2))
    pos[:, 2] = (np.arange(n) % 8) * 100.0 + 50.0
    out2, _ = serve_both(GRID, pos, host(out["committed_prev"]), valid, qs, subs,
                         bucket=2, per_shard=16, now=153)
    assert not host(out2["undelivered"]).any()
    assert int(out2["cell_counts"].sum()) == n


def test_query_diff_rows_match_dense_from_sharded_interest():
    """The standing-query changed rows from the cells plane's gathered
    [Q, C] planes equal the dense step's, and a second diff against the
    committed baseline is empty."""
    pos, prev, valid, qs, subs = serving_world()
    out, pq = serve_both(GRID_6x4, pos, prev, valid, qs, subs)
    dense = dense_step(GRID_6x4, pos, prev, valid, pq, subs)
    zero_i = torch.zeros_like(dense["interest"])
    zero_d = torch.zeros_like(dense["dist"])

    def rows_of(interest, dist):
        blob, next_i, next_d = T.diff_query_masks(zero_i, zero_d, interest, dist, 4096)
        count, rows = T.parse_query_blob(blob.numpy())
        return count, rows[:count].tolist(), next_i, next_d

    n_dense, dense_rows, base_i, base_d = rows_of(dense["interest"], dense["dist"])
    n_shard, shard_rows, _, _ = rows_of(out["interest"], out["dist"])
    assert (n_dense, dense_rows) == (n_shard, shard_rows)
    assert n_dense == int(dense["interest"].sum())
    blob2, _, _ = T.diff_query_masks(base_i, base_d, out["interest"], out["dist"], 4096)
    assert T.parse_query_blob(blob2.numpy())[0] == 0
    jblob, _, _ = J.diff_query_masks(jnp.zeros((8, 24), bool), jnp.zeros((8, 24), jnp.int32),
                                     jnp.asarray(out["interest"].numpy()),
                                     jnp.asarray(out["dist"].numpy()), 4096)
    jcount, jrows = J.parse_query_blob(np.asarray(jblob))
    assert (jcount, sorted(map(tuple, jrows[:jcount].tolist()))) == (
        n_shard, sorted(map(tuple, shard_rows)))


def fused_cell_centres(grid, cell_ids):
    """The cell centre as XLA:CPU computes it with runtime ids: ``(col +
    0.5) * w + offset`` rounded once (the float32 product is exact in
    float64; the float64 sum is then rounded to float32)."""
    cols = int(grid.cols)
    col = (cell_ids % cols).to(torch.float64)
    row = torch.div(cell_ids, cols, rounding_mode="floor").to(torch.float64)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return (((col + 0.5) * f32(grid.cell_w) + f32(grid.offset_x)).to(torch.float32),
            ((row + 0.5) * f32(grid.cell_h) + f32(grid.offset_z)).to(torch.float32))


def test_cells_plane_differs_from_jax_only_by_the_fused_cell_centre(monkeypatch):
    """F6 on the cells plane. 11x5 cells of 37.3 x 61.1 m, 256 queries of
    every geometric kind, a quarter on cell corners: the port's plane
    equals its own dense step exactly, and JAX's plane on every output
    but the AOI pairs whose cell centre XLA:CPU contracts into an FMA —
    here 8 interest bits and 13 dists of 14,080 pairs. Recomputing the
    centres fused (and nothing else) gives JAX's planes exactly."""
    from test_torch_spatial_ops import queries

    grid = GRID_ODD
    rng = np.random.default_rng(102)
    jq, pq = queries(grid, 256, rng, with_spots=False)
    n = 64
    pos = rng.uniform(grid.offset_x, grid.offset_x + grid.cell_w * grid.cols,
                      (n, 3)).astype(np.float32)
    prev, valid = np.full(n, -1, np.int32), np.ones(n, bool)
    subs = (np.zeros(8, np.int32), np.full(8, 50, np.int32), np.ones(8, bool))
    jm, pm = meshes()
    jax_out = JA.cell_serving_spatial_step(
        JA.build_cell_serving_step(grid, jm, 8, 8), *map(jnp.asarray, (pos, prev, valid)), jq,
        tuple(map(jnp.asarray, subs)), 120)

    def port_plane():
        return TA.cell_serving_spatial_step(
            TA.build_cell_serving_step(grid, pm, 8, 8), *map(torch.tensor, (pos, prev, valid)),
            pq, tuple(map(torch.tensor, subs)), 120)

    out = port_plane()
    assert_equals_dense(out, dense_step(grid, pos, prev, valid, pq, subs))
    ji, jd = np.asarray(jax_out["interest"]), np.asarray(jax_out["dist"])
    hit_diff = int((ji != out["interest"].numpy()).sum())
    dist_diff = int((jd != out["dist"].numpy()).sum())
    assert (hit_diff, dist_diff, ji.size) == (8, 13, 14080)
    assert_outputs_equal({k: v for k, v in jax_out.items() if k not in ("interest", "dist")},
                         {k: v for k, v in out.items() if k not in ("interest", "dist")})
    monkeypatch.setattr(T, "cell_centres", fused_cell_centres)
    fused = port_plane()
    np.testing.assert_array_equal(ji, fused["interest"].numpy())
    np.testing.assert_array_equal(jd, fused["dist"].numpy())


@pytest.mark.parametrize("base,count", [(203, 29), (0, 29), (224, 8)])
def test_aoi_block_past_the_grid_equals_jax(base, count):
    """K2's wrapper over a block of cell ids [base, base + count) on the
    sidecar's 15x15 grid, as the cells plane asks for shard 7 of 8
    (cells_per_shard(225, 8) = 29: ids 203..231, the last 7 past C):
    the plain path (CPU tensors) with the spots overlay equals the JAX
    reference's aoi_masks_for_cells over constant ids, and ids >= C are
    never interested."""
    from test_torch_spatial_ops import GRIDS, queries

    grid = GRIDS["15x15"]
    jq, pq = queries(grid, 96, np.random.default_rng(base), with_spots=True)
    ids = np.arange(base, base + count, dtype=np.int32)
    c = grid.num_cells
    spot = np.pad(np.asarray(jq.spot_dist), ((0, 0), (0, 8 * 29 - c)),
                  constant_values=-1)[:, base:base + count]
    ref = jax.jit(lambda q, sd: J.aoi_masks_for_cells(grid, q, jnp.asarray(ids), sd))
    jh, jd = ref(jq, jnp.asarray(spot))
    th, td = K.aoi_block_cuda(grid, pq, base, count, torch.tensor(spot))
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert not th.numpy()[:, ids >= c].any()
    assert TA.cells_per_shard(grid, 8) == 29
