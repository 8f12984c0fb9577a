"""channeld_tpu_torch.ops.cuda_kernels: plain versions against the TPU
kernels, wrappers on the CPU, and each CUDA kernel against its plain
version on the card.

The TPU kernels run as tests/test_pallas.py runs them on the CPU:
``assign_and_count_pallas(..., interpret=True)`` and
``aoi_masks_pallas(..., interpret=True)``. Distances are compared where
there is interest, as there. The kernel-vs-plain case needs a CUDA card
and skips without one; JAX is imported only inside the tests that
compare with it, so on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from channeld_tpu_torch.ops import cuda_kernels as K
from channeld_tpu_torch.ops import spatial_ops as T

GRIDS = {
    "8x8": T.GridSpec(-400.0, -400.0, 100.0, 100.0, 8, 8),
    "15x15": T.GridSpec(-15000.0, -15000.0, 2000.0, 2000.0, 15, 15),
}
WIDE = T.GridSpec(-25600.0, -25600.0, 200.0, 200.0, 256, 256)


def entity_inputs(grid, n, rng):
    lo_x, hi_x = grid.offset_x - grid.cell_w, grid.offset_x + grid.cell_w * (grid.cols + 1)
    lo_z, hi_z = grid.offset_z - grid.cell_h, grid.offset_z + grid.cell_h * (grid.rows + 1)
    pos = np.stack([rng.uniform(lo_x, hi_x, n), rng.uniform(-5, 5, n),
                    rng.uniform(lo_z, hi_z, n)], axis=1).astype(np.float32)
    k = n // 4
    pos[:k, 0] = grid.offset_x + rng.integers(-1, grid.cols + 2, k) * grid.cell_w
    pos[:k, 2] = grid.offset_z + rng.integers(-1, grid.rows + 2, k) * grid.cell_h
    for i, v in enumerate([np.nan, np.inf, -np.inf, 1e20]):
        pos[k + 2 * i, 0] = v
        pos[k + 2 * i + 1, 2] = v
    valid = rng.random(n) > 0.1
    return pos, valid


def crowd_inputs(grid, n, rng):
    """Half of the slots in one cell (a town square, a raid), the rest
    over the grid and its margin as in entity_inputs."""
    pos, valid = entity_inputs(grid, n, rng)
    crowd = rng.permutation(n)[: n // 2]
    pos[crowd, 0] = grid.offset_x + grid.cell_w * (3 + rng.random(crowd.size))
    pos[crowd, 2] = grid.offset_z + grid.cell_h * (5 + rng.random(crowd.size))
    valid[crowd] = True
    return pos, valid


def edge_query_inputs(grid, q, rng):
    """Boundary-heavy queries: a third centred on cell corners, some on
    cell edges in one axis, and extents of 0, -0, negative, NaN and inf
    on either axis (radius included), plus a few NaN/inf centres."""
    kind, center, extent, direction, angle, _ = query_inputs(grid, q, rng)
    kind[kind == T.AOI_SPOTS] = T.AOI_CONE
    third = q // 3
    center[third: 2 * third, 0] = (grid.offset_x + rng.integers(-1, grid.cols + 1, third)
                                   * grid.cell_w).astype(np.float32)
    special = np.array([0.0, -0.0, -5.0, np.nan, np.inf, -np.inf, 1e-40, 1e20],
                       np.float32)
    pick = rng.random((q, 2)) < 0.3
    extent[pick] = rng.choice(special, pick.sum())
    # Exact multiples of half a cell, so gaps and box reaches land on edges.
    halves = rng.random((q, 2)) < 0.2
    extent[halves] = (rng.integers(0, 8, halves.sum()) * grid.cell_w * 0.5).astype(np.float32)
    odd = rng.choice(q, 4, replace=False)
    center[odd] = np.array([[np.nan, 0.0], [0.0, np.inf], [-np.inf, 0.0], [1e20, -1e20]],
                           np.float32)
    return kind, center, extent, direction, angle


def aoi_separable(grid, kind, center, extent, direction, cos_angle, cell_base, cell_count):
    """K2's algorithm (csrc/aoi.cu) in torch: per-axis terms once per
    (query, column) and (query, row), only the sums per pair, kind gating,
    and the sphere/cone test as rect_s <= sqrt_threshold(radius) with no
    root of the rectangle distance."""
    ids = torch.arange(cell_base, cell_base + cell_count, dtype=torch.int64)
    col, row = ids % grid.cols, ids // grid.cols
    half_w, half_h = grid.cell_w * 0.5, grid.cell_h * 0.5

    def axis(index, size, offset, half, qc, dirc, ext):
        centre = (index.to(torch.float32) + 0.5) * size + offset
        dd = qc[:, None] - centre[None, :]
        d = dd.abs()
        gap = torch.maximum(d - half, torch.zeros_like(d))
        return dd * dd, gap * gap, (-dd) * dirc[:, None], d <= (ext + half)[:, None]

    cols = torch.arange(grid.cols)
    rows = torch.arange(int(row.max()) + 1)
    d2x, g2x, px, bx = axis(cols, grid.cell_w, grid.offset_x, half_w, center[:, 0],
                            direction[:, 0], extent[:, 0])
    d2z, g2z, pz, bz = axis(rows, grid.cell_h, grid.offset_z, half_h, center[:, 1],
                            direction[:, 1], extent[:, 1])
    rect_s = g2x[:, col] + g2z[:, row]
    center_dist = T.sqrt_rn(d2x[:, col] + d2z[:, row])
    apex = rect_s <= 0.0
    inside = rect_s <= K.sqrt_threshold(extent[:, 0])[:, None]
    to_len = torch.maximum(center_dist, torch.full_like(center_dist, 1e-9))
    in_angle = (px[:, col] + pz[:, row]) / to_len >= cos_angle[:, None]
    k = kind[:, None]
    hit = (((k == T.AOI_SPHERE) & inside) | ((k == T.AOI_BOX) & bx[:, col] & bz[:, row])
           | ((k == T.AOI_CONE) & inside & (apex | in_angle)))
    hit &= (ids < grid.num_cells)[None, :]
    dist = T._f32_to_i32(torch.ceil(center_dist * T.reciprocal(grid.diagonal)))
    return hit, torch.where(apex, 0, dist).to(torch.int32)


def query_inputs(grid, q, rng):
    """kind, center, extent, direction, angle, spot_dist (spots every 7th)."""
    kind = rng.integers(0, 4, q).astype(np.int32)
    kind[::7] = T.AOI_SPOTS
    spot = np.full((q, grid.num_cells), -1, np.int32)
    hits = rng.random(spot.shape) < 0.2
    spot[hits] = rng.integers(0, 5, hits.sum())
    lo = grid.offset_x - grid.cell_w
    hi = grid.offset_x + grid.cell_w * (grid.cols + 1)
    center = rng.uniform(lo, hi, (q, 2)).astype(np.float32)
    center[: q // 3] = (grid.offset_x + rng.integers(-1, grid.cols + 1, (q // 3, 2))
                        * grid.cell_w).astype(np.float32)
    extent = rng.uniform(1.0, grid.cell_w * 4, (q, 2)).astype(np.float32)
    direction = rng.normal(size=(q, 2)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    angle = rng.uniform(0.1, 1.5, q).astype(np.float32)
    return kind, center, extent, direction, angle, spot


def test_assign_count_plain_matches_tpu_kernel():
    import jax.numpy as jnp

    from channeld_tpu.ops.pallas_kernels import assign_and_count_pallas

    grid = GRIDS["15x15"]
    pos, valid = entity_inputs(grid, 5000, np.random.default_rng(3))
    jc, jn = assign_and_count_pallas(grid, jnp.asarray(pos), jnp.asarray(valid),
                                     interpret=True)
    tc, tn = K.assign_and_count_plain(grid, torch.from_numpy(pos), torch.from_numpy(valid))
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jn), tn.numpy())
    assert tn.dtype == torch.int32 and int(tn.sum()) == int((tc >= 0).sum())


def test_assign_count_crowd_matches_tpu_kernel():
    """Half of the slots in one cell: the input that makes warp-aggregated
    atomics matter on the card. The plain version and the TPU kernel
    agree exactly, and the crowd's cell holds its half."""
    import jax.numpy as jnp

    from channeld_tpu.ops.pallas_kernels import assign_and_count_pallas

    grid = GRIDS["15x15"]
    pos, valid = crowd_inputs(grid, 6000, np.random.default_rng(21))
    jc, jn = assign_and_count_pallas(grid, jnp.asarray(pos), jnp.asarray(valid),
                                     interpret=True)
    tc, tn = K.assign_and_count_plain(grid, torch.from_numpy(pos), torch.from_numpy(valid))
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jn), tn.numpy())
    assert int(tn[3 + 5 * grid.cols]) >= 3000


@pytest.mark.parametrize("ex", [0.0, -0.0, 1e-45, 3e-39, 1e-30, 1e-22, 1.0, 2000.0,
                                1e19, 1.8446743e19, 3e38, np.inf, np.nan, -1.0])
def test_sqrt_threshold_equals_the_root_test(ex):
    """s <= sqrt_threshold(ex) equals sqrt(s) <= ex on every float s
    within 64 ulps of the threshold (and of ex*ex, 0 and inf), NaN s
    included."""
    r = torch.tensor([ex], dtype=torch.float32)
    t = K.sqrt_threshold(r)
    with np.errstate(over="ignore"):
        centres = [np.float32(ex) * np.float32(ex), np.float32(0.0),
                   np.finfo(np.float32).max]
    if np.isfinite(t.item()) and t.item() >= 0:
        centres.append(np.float32(t.item()))
    bits = np.concatenate([np.array([c], np.float32).view(np.int32) + np.arange(-64, 65)
                           for c in centres if np.isfinite(c)])
    bits = bits[(bits >= 0) & (bits <= 0x7F800000)]  # +0 .. +inf
    s = torch.from_numpy(np.concatenate([bits.view(np.float32),
                                         np.array([np.nan, np.inf], np.float32)]))
    assert torch.equal(T.sqrt_rn(s) <= r, s <= t)
    if ex == ex and ex >= 0 and ex != np.inf:
        assert T.sqrt_rn(t) <= r  # the threshold itself passes


@pytest.mark.parametrize("case", ["15x15", "256x256", "cell_block"])
def test_separable_aoi_matches_plain_and_tpu_kernel(case):
    """The separable, kind-gated algorithm the CUDA kernel runs, written
    in torch, against the plain version (every hit and dist bit) and the
    TPU kernel in interpret mode (every hit bit; dist where there is
    interest, as above), on boundary-heavy queries with zero, negative,
    NaN and inf extents. cos(angle) comes from XLA for all three."""
    import jax
    import jax.numpy as jnp

    from channeld_tpu.ops import spatial_ops as J
    from channeld_tpu.ops.pallas_kernels import _aoi_masks_pallas_geom

    grid = WIDE if case == "256x256" else GRIDS["15x15"]
    q = 12 if case == "256x256" else 61
    kind, center, extent, direction, angle = edge_query_inputs(
        grid, q, np.random.default_rng(17))
    cos_a = np.array(jax.jit(jnp.cos)(jnp.asarray(angle)))
    jh, jd = _aoi_masks_pallas_geom(J.GridSpec(*grid), tuple(map(jnp.asarray, (
        kind, center, extent, direction, angle))), interpret=True)
    jh, jd = np.asarray(jh).astype(bool), np.asarray(jd)
    base, count = (70, 100) if case == "cell_block" else (0, grid.num_cells)
    jh, jd = jh[:, base:base + count], jd[:, base:base + count]
    args = [torch.from_numpy(a) for a in (kind, center, extent, direction, cos_a)]
    mh, md = aoi_separable(grid, *args, base, count)
    ph, pd = K.aoi_tile_plain(grid, *args, base, count)
    assert torch.equal(mh, ph) and torch.equal(md, pd)
    assert np.array_equal(mh.numpy(), jh)
    assert np.array_equal(md.numpy()[jh], jd[jh])
    for k in (T.AOI_SPHERE, T.AOI_BOX, T.AOI_CONE):  # every kind hits somewhere
        assert jh[kind == k].any()


@pytest.mark.parametrize("with_spots", [False, True])
@pytest.mark.parametrize("name", GRIDS)
def test_aoi_plain_matches_tpu_kernel(name, with_spots):
    """29 queries (not a multiple of the TPU kernel's 8-query tile), every
    kind, and the spots overlay."""
    import jax.numpy as jnp

    from channeld_tpu.ops import spatial_ops as J
    from channeld_tpu.ops.pallas_kernels import aoi_masks_pallas

    grid = J.GridSpec(*GRIDS[name])
    kind, center, extent, direction, angle, spot = query_inputs(
        grid, 29, np.random.default_rng(11))
    if not with_spots:
        kind[kind == T.AOI_SPOTS] = T.AOI_SPHERE
    arrays = (kind, center, extent, direction, angle)
    jq = J.QuerySet(*map(jnp.asarray, arrays), jnp.asarray(spot) if with_spots else None)
    tq = T.QuerySet(*map(torch.from_numpy, arrays),
                    torch.from_numpy(spot) if with_spots else None)
    jh, jd = aoi_masks_pallas(grid, jq, interpret=True)
    th, td = K.aoi_masks_cuda(grid, tq)
    jh = np.asarray(jh)
    assert th.dtype == torch.bool and td.dtype == torch.int32
    assert np.array_equal(jh, th.numpy())
    assert np.array_equal(np.asarray(jd)[jh], td.numpy()[jh])
    assert jh.any()


def test_wrappers_take_the_plain_path_on_cpu_tensors():
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing: both counts stay 0."""
    K.reset_launch_counts()
    grid = GRIDS["8x8"]
    rng = np.random.default_rng(5)
    pos, valid = (torch.from_numpy(a) for a in entity_inputs(grid, 300, rng))
    for a, b in zip(K.assign_and_count(grid, pos, valid),
                    K.assign_and_count_plain(grid, pos, valid)):
        assert torch.equal(a, b)
    kind, center, extent, direction, angle, _ = (
        torch.from_numpy(a) for a in query_inputs(grid, 13, rng))
    cos_a = torch.cos(angle)
    for base, count in ((0, None), (10, 30)):
        for a, b in zip(K.aoi_tile(grid, kind, center, extent, direction, cos_a, base, count),
                        K.aoi_tile_plain(grid, kind, center, extent, direction, cos_a,
                                         base, count)):
            assert torch.equal(a, b)
    assert K.launch_counts() == {"assign_count": 0, "aoi": 0}


class _FailingLib:
    @staticmethod
    def chtpu_error_string(code):
        return b"launch failed"


def test_k1_counts_buffers_follow_their_stream(monkeypatch):
    """K1's zero-ahead counts: a launch takes the buffer that the last
    launch on its own stream zeroed, never another stream's or another
    bin count's, and after a launch that failed it takes a new zeroed
    buffer, not the one the failed launch was to zero."""
    monkeypatch.setattr(K, "_zeroed", {})
    cpu = torch.device("cpu")
    a, a_next, a_done = K._counts_pair(cpu, 11, 9)
    assert torch.equal(a, torch.zeros(9, dtype=torch.int32))
    a_done()
    b, _, b_done = K._counts_pair(cpu, 22, 9)  # another stream
    c, _, _ = K._counts_pair(cpu, 11, 16)  # another bin count
    assert b is not a_next and c is not a_next
    assert not b.any() and not c.any()
    b_done()
    again, again_next, again_done = K._counts_pair(cpu, 11, 9)
    assert again is a_next  # zeroed on the device by the launch before
    again_next.fill_(7)  # what a launch that never ran leaves behind
    failed = K.Launch("assign_count", _FailingLib, lambda *args: 1, (), (), again_done)
    with pytest.raises(RuntimeError, match="failed to launch"):
        failed.run()
    fresh, _, _ = K._counts_pair(cpu, 11, 9)
    assert fresh is not again_next and not fresh.any()


def test_k1_refuses_cuda_graph_capture(monkeypatch):
    """Under CUDA-graph capture K1 raises before it takes a counts buffer:
    a replay would add to the counts of the replay before."""
    monkeypatch.setattr(K, "_zeroed", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    grid = GRIDS["8x8"]
    pos, valid = (torch.from_numpy(a) for a in entity_inputs(grid, 40, np.random.default_rng(8)))
    with pytest.raises(RuntimeError, match="CUDA graph"):
        K.prepare_assign_count(grid, pos, valid)
    assert K._zeroed == {}


def test_cell_block_is_a_slice_of_the_full_plane():
    grid = GRIDS["8x8"]
    kind, center, extent, direction, angle, _ = (
        torch.from_numpy(a) for a in query_inputs(grid, 17, np.random.default_rng(6)))
    cos_a = torch.cos(angle)
    hit, dist = K.aoi_tile(grid, kind, center, extent, direction, cos_a)
    hb, db = K.aoi_tile(grid, kind, center, extent, direction, cos_a, 20, 25)
    assert torch.equal(hb, hit[:, 20:45]) and torch.equal(db, dist[:, 20:45])


@pytest.mark.parametrize("bad", ["dtype", "shape", "device_mix", "noncontiguous", "block"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    grid = GRIDS["8x8"]
    pos = torch.zeros(10, 3)
    valid = torch.ones(10, dtype=torch.bool)
    kind = torch.zeros(4, dtype=torch.int32)
    vec2 = torch.zeros(4, 2)
    cos_a = torch.zeros(4)
    if bad == "dtype":
        with pytest.raises(TypeError):
            K.assign_and_count(grid, pos.double(), valid)
        with pytest.raises(TypeError):
            K.aoi_tile(grid, kind.long(), vec2, vec2, vec2, cos_a)
    elif bad == "shape":
        with pytest.raises(ValueError):
            K.assign_and_count(grid, pos[:, :2].contiguous(), valid)
        with pytest.raises(ValueError):
            K.aoi_tile(grid, kind, vec2[:3], vec2, vec2, cos_a)
    elif bad == "device_mix":
        with pytest.raises(ValueError):
            K.assign_and_count(grid, pos, valid.to("meta"))
    elif bad == "noncontiguous":
        with pytest.raises(ValueError):
            K.assign_and_count(grid, torch.zeros(3, 10).t(), valid)
    else:
        with pytest.raises(ValueError):
            K.aoi_tile(grid, kind, vec2, vec2, vec2, cos_a, -1, 5)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_the_card():
    """Each CUDA kernel against its plain version on the same CUDA
    tensors, exact: K1 on both histogram paths (shared memory and global
    atomics), on crowds, at 1,048,576 slots, with no slots, and twice in
    a row (each launch zeroes the counts buffer of the next); K2 with
    and without its shared column table, on edge extents and on cell
    blocks (whole rows and not), one running past the grid. The counts move once per launch.
    Builds the kernels from the sources on first use."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    K.reset_launch_counts()
    rng = np.random.default_rng(7)
    long_grid = T.GridSpec(-2048.0, -100.0, 1.0, 50.0, 2048, 4)  # no column table
    k1 = [(GRIDS["15x15"], True, entity_inputs(GRIDS["15x15"], 50_000, rng)),
          (GRIDS["15x15"], True, crowd_inputs(GRIDS["15x15"], 50_000, rng)),
          (GRIDS["15x15"], True, entity_inputs(GRIDS["15x15"], 1 << 20, rng)),
          (GRIDS["15x15"], True, (np.zeros((0, 3), np.float32), np.zeros(0, bool))),
          (WIDE, False, entity_inputs(WIDE, 50_000, rng)),
          (WIDE, False, crowd_inputs(WIDE, 50_000, rng))]
    for grid, shared, arrays in k1:
        assert K.uses_shared_histogram(grid, dev) is shared
        pos, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        want = K.assign_and_count_plain(grid, pos, valid)
        for _ in range(2):
            for a, b in zip(K.assign_and_count(grid, pos, valid), want):
                assert torch.equal(a, b)
    for grid in (GRIDS["15x15"], WIDE, long_grid):
        for make in (query_inputs, edge_query_inputs):
            kind, center, extent, direction, angle = (
                torch.from_numpy(a).to(dev) for a in make(grid, 300, rng)[:5])
            cos_a = torch.cos(angle)
            c = grid.num_cells
            for base, count in ((0, None), (c // 3, c // 2 + 7), (c // 4, c // 2), (c - 12, 40)):
                for a, b in zip(
                        K.aoi_tile(grid, kind, center, extent, direction, cos_a, base, count),
                        K.aoi_tile_plain(grid, kind, center, extent, direction, cos_a,
                                         base, count)):
                    assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"assign_count": 12, "aoi": 24}


@pytest.mark.cuda
def test_mesh_steps_run_both_kernels_per_shard_on_the_card():
    """The sharded steps on 8 shards of one card (a mesh of repeated
    devices) against the same steps on 8 CPU shards, every output equal:
    K1 launches once per shard in both planes and K2 once (entity plane)
    or once per shard (cells plane: 15x15 cells in blocks of 29, the
    last running past the grid to id 231); the psum of the per-shard K1
    counts equals the plain counts, and a block past C equals its plain
    version with no interest past the grid."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.parallel import mesh as PM
    from channeld_tpu_torch.parallel import spatial_alltoall as PA

    dev = torch.device("cuda", 0)
    grid = GRIDS["15x15"]
    rng = np.random.default_rng(11)
    pos, valid = entity_inputs(grid, 1 << 14, rng)
    prev = rng.integers(-1, grid.num_cells, 1 << 14).astype(np.int32)
    qs = query_inputs(grid, 512, rng)[:5]
    subs = (rng.integers(0, 100, 64).astype(np.int32), np.full(64, 50, np.int32),
            rng.random(64) < 0.9)

    def run(device, cells):
        mesh = (PA.make_space_mesh if cells else PM.make_mesh)([device] * 8)
        args = [torch.from_numpy(a).to(device) for a in (pos, prev, valid)]
        q = T.QuerySet(*(torch.from_numpy(a).to(device) for a in qs))
        sub = tuple(torch.from_numpy(a).to(device) for a in subs)
        if cells:
            return PA.cell_serving_spatial_step(PA.build_cell_serving_step(grid, mesh, 256, 64),
                                                *args, q, sub, 120)
        return PM.sharded_spatial_step(PM.build_sharded_step(grid, mesh, 64), *args, q, sub, 120)

    for cells in (False, True):
        want = run(torch.device("cpu"), cells)
        K.reset_launch_counts()
        got = run(dev, cells)
        torch.cuda.synchronize()
        assert K.launch_counts() == {"assign_count": 8, "aoi": 8 if cells else 1}
        for key, value in want.items():
            a = torch.cat(value) if isinstance(value, list) else value
            b = torch.cat(got[key]).cpu() if isinstance(got[key], list) else got[key].cpu()
            assert torch.equal(a, b), key
    counts = torch.zeros(grid.num_cells, dtype=torch.int32, device=dev)
    for part_pos, part_valid in zip(torch.from_numpy(pos).to(dev).chunk(8),
                                    torch.from_numpy(valid).to(dev).chunk(8)):
        counts += K.assign_and_count(grid, part_pos, part_valid)[1]
    plain = K.assign_and_count_plain(grid, torch.from_numpy(pos).to(dev),
                                     torch.from_numpy(valid).to(dev))[1]
    assert torch.equal(counts, plain)
    kind, center, extent, direction, angle = (torch.from_numpy(a).to(dev) for a in qs)
    cos_a = torch.cos(angle)
    hit, dist = K.aoi_tile(grid, kind, center, extent, direction, cos_a, 203, 29)
    hit_p, dist_p = K.aoi_tile_plain(grid, kind, center, extent, direction, cos_a, 203, 29)
    assert torch.equal(hit, hit_p) and torch.equal(dist, dist_p)
    assert not hit[:, 225 - 203:].any()
