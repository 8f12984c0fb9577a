"""channeld_tpu_torch.ops.spatial_ops against channeld_tpu.ops.spatial_ops.

The same seeded numpy inputs go through the JAX function and its port
(on the CPU, where the port's kernel wrappers take the plain path).
Every output is int or bool, so every comparison is exact.

The JAX functions run as the reference runs them: jitted with the grid
static. XLA then folds a division by a grid constant into a
multiplication by its float32 reciprocal, which the port reproduces;
``test_reference_folds_division_under_jit`` pins that the eager
reference function would give other cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from channeld_tpu.ops import spatial_ops as J
from channeld_tpu_torch.ops import spatial_ops as T

GRIDS = {
    "8x8": J.GridSpec(-400.0, -400.0, 100.0, 100.0, 8, 8),
    "15x15": J.GridSpec(-15000.0, -15000.0, 2000.0, 2000.0, 15, 15),
    "11x5-neg": J.GridSpec(-317.5, -123.25, 37.3, 61.1, 11, 5),
}


assign_cells = jax.jit(J.assign_cells, static_argnums=0)
aoi_masks = jax.jit(J.aoi_masks, static_argnums=0)
aoi_masks_for_cells = jax.jit(J.aoi_masks_for_cells, static_argnums=0)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a)


def positions(grid, n, rng):
    """Uniform over the grid and a margin, a third exactly on cell
    boundaries, plus NaN, ±inf and ±1e20 on either axis."""
    lo_x, hi_x = grid.offset_x - grid.cell_w, grid.offset_x + grid.cell_w * (grid.cols + 1)
    lo_z, hi_z = grid.offset_z - grid.cell_h, grid.offset_z + grid.cell_h * (grid.rows + 1)
    pos = np.stack([rng.uniform(lo_x, hi_x, n), rng.uniform(-5, 5, n),
                    rng.uniform(lo_z, hi_z, n)], axis=1).astype(np.float32)
    k = n // 3
    pos[:k, 0] = grid.offset_x + rng.integers(-1, grid.cols + 2, k) * grid.cell_w
    pos[:k, 2] = grid.offset_z + rng.integers(-1, grid.rows + 2, k) * grid.cell_h
    for i, v in enumerate([np.nan, np.inf, -np.inf, 1e20, -1e20]):
        pos[k + 3 * i, 0] = v
        pos[k + 3 * i + 1, 2] = v
        pos[k + 3 * i + 2] = (v, v, v)
    return pos


def queries(grid, q, rng, with_spots):
    kind = rng.integers(0, 4, q).astype(np.int32)  # NONE..CONE
    spot = None
    if with_spots:
        kind[::5] = J.AOI_SPOTS
        spot = np.full((q, grid.num_cells), -1, np.int32)
        hits = rng.random(spot.shape) < 0.2
        spot[hits] = rng.integers(0, 5, hits.sum())
    lo = grid.offset_x - grid.cell_w
    hi = grid.offset_x + grid.cell_w * (grid.cols + 1)
    center = rng.uniform(lo, hi, (q, 2)).astype(np.float32)
    center[: q // 3] = (grid.offset_x + rng.integers(-1, grid.cols + 1, (q // 3, 2))
                        * grid.cell_w).astype(np.float32)
    extent = rng.uniform(1.0, grid.cell_w * 4, (q, 2)).astype(np.float32)
    extent[: q // 4] = np.float32(grid.cell_w)  # box edges on cell edges
    direction = rng.normal(size=(q, 2)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    angle = rng.uniform(0.05, 1.5, q).astype(np.float32)
    arrays = (kind, center, extent, direction, angle)
    jq = J.QuerySet(*map(j, arrays), None if spot is None else j(spot))
    tq = T.QuerySet(*map(t, arrays), None if spot is None else t(spot))
    return jq, tq


def assert_same(jax_out, torch_out):
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", GRIDS)
def test_assign_cells_and_counts(name):
    grid = GRIDS[name]
    rng = np.random.default_rng(1)
    pos = positions(grid, 3000, rng)
    valid = rng.random(3000) > 0.1
    jc = assign_cells(grid, j(pos), j(valid))
    tc = T.assign_cells(grid, t(pos), t(valid))
    assert_same(jc, tc)
    assert_same(J.cell_counts(jc, grid.num_cells), T.cell_counts(tc, grid.num_cells))
    # NaN on an axis counts as index 0 there (XLA's conversion, F1);
    # ±inf and ±1e20 fall outside.
    k = 1000
    assert tc[k + 2].item() == (0 if valid[k + 2] else -1)  # (NaN, NaN, NaN)
    assert tc[k + 5].item() == -1 and tc[k + 14].item() == -1


def test_reference_folds_division_under_jit():
    """On a grid whose cell size is not a power of two, the jitted
    reference assigns boundary points differently from its eager form;
    the port follows the jitted one (the reference's main path)."""
    grid = GRIDS["11x5-neg"]
    rng = np.random.default_rng(9)
    pos = positions(grid, 3000, rng)
    valid = np.ones(3000, bool)
    jitted = np.asarray(assign_cells(grid, j(pos), j(valid)))
    eager = np.asarray(J.assign_cells(grid, j(pos), j(valid)))
    assert (jitted != eager).any()
    assert np.array_equal(T.assign_cells(grid, t(pos), t(valid)).numpy(), jitted)


@pytest.mark.parametrize("max_out", [1, 7, 64, 10_000])
def test_handover_detection_and_compaction(max_out):
    rng = np.random.default_rng(2)
    n = 600
    old = rng.integers(-1, 20, n).astype(np.int32)
    new = np.where(rng.random(n) < 0.3, rng.integers(-1, 20, n), old).astype(np.int32)
    jm = J.detect_handovers(j(old), j(new))
    tm = T.detect_handovers(t(old), t(new))
    assert_same(jm, tm)
    for a, b in zip(J.compact_handovers(jm, j(old), j(new), max_out),
                    T.compact_handovers(tm, t(old), t(new), max_out)):
        assert_same(a, b)


@pytest.mark.parametrize("with_spots", [False, True])
@pytest.mark.parametrize("name", GRIDS)
def test_aoi_masks(name, with_spots):
    grid = GRIDS[name]
    jq, tq = queries(grid, 97, np.random.default_rng(3), with_spots)
    jh, jd = aoi_masks(grid, jq)
    th, td = T.aoi_masks(grid, tq)
    assert_same(jh, th)
    assert_same(jd, td)
    assert th.any() and not th.all()


def test_aoi_masks_for_cell_block_with_padding():
    """A block of cell ids with padding on both sides. The ids are
    constants of the jitted reference, as in its own ``aoi_masks``: with
    runtime ids XLA:CPU contracts the cell centre's product and sum into
    an FMA, which the port does not (see ROADMAP.md, F6)."""
    grid = GRIDS["11x5-neg"]
    jq, tq = queries(grid, 40, np.random.default_rng(4), with_spots=True)
    ids = np.arange(-3, grid.num_cells + 5, dtype=np.int32)[::2]
    spot = np.asarray(jq.spot_dist)[:, np.clip(ids, 0, grid.num_cells - 1)]
    ref = jax.jit(lambda q, sd: J.aoi_masks_for_cells(grid, q, jnp.asarray(ids), sd))
    jh, jd = ref(jq, j(spot))
    th, td = T.aoi_masks_for_cells(grid, tq, t(ids), t(spot))
    assert_same(jh, th)
    assert_same(jd, td)
    pad = (ids < 0) | (ids >= grid.num_cells)
    assert not th.numpy()[:, pad].any()


def test_sum_of_squares_rounds_each_product():
    """XLA:CPU compiles the reference's two-term sum of squares with the
    last product fused into an FMA; the port (and its CUDA kernel, built
    with -fmad=false) rounds each product, as the source expression and
    the TPU kernel read. Pinned on the one pair of 16.4M measured where
    that changes a result: a sphere query with no interest in the cell,
    whose damping distance is 28 under the FMA and 27 without."""
    grid = J.GridSpec(0.0, 0.0, 0.1, 0.3, 64, 64)
    arrays = (np.array([1], np.int32),
              np.array([[4.858593463897705, 6.3024468421936035]], np.float32),
              np.array([[0.2942255437374115, 0.1298111230134964]], np.float32),
              np.array([[1.0, 0.0]], np.float32), np.array([0.5], np.float32))
    jh, jd = aoi_masks(grid, J.QuerySet(*map(j, arrays)))
    th, td = T.aoi_masks(grid, T.QuerySet(*map(t, arrays)))
    assert not np.asarray(jh)[0, 3098] and not th[0, 3098]
    assert int(np.asarray(jd)[0, 3098]) == 28
    assert int(td[0, 3098]) == 27
    f32 = np.float32
    cx = (f32(3098 % 64) + f32(0.5)) * f32(0.1) + f32(0.0)
    cz = (f32(3098 // 64) + f32(0.5)) * f32(0.3) + f32(0.0)
    dx, dz = arrays[1][0, 0] - cx, arrays[1][0, 1] - cz
    separate = np.sqrt(dx * dx + dz * dz) * f32(T.reciprocal(grid.diagonal))
    assert np.ceil(separate) == 27


def test_fma_f32_rounds_once():
    """``fma_f32`` is fmaf: ``a * b + c`` rounded once to float32, equal
    to the exactly rounded rational on seeded operands, including
    (29.5, 8.677966, 2^32), where a float64 sum rounded again to
    float32 lands 512 low. On 11x5 cells of 37.3 x 61.1 m the fused
    centres differ from the unfused ones (the cells plane's F6)."""
    from fractions import Fraction

    def rounded(a, b, c):
        exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        return min(near, key=lambda x: (abs(Fraction(float(x)) - exact),
                                        int(np.array(x, np.float32).view(np.int32)) & 1))

    rng = np.random.default_rng(6)
    a = (rng.integers(0, 1 << 16, 400) + 0.5).astype(np.float32)
    b = (rng.uniform(1e-3, 1e3, 400) * 10.0 ** rng.integers(-3, 3, 400)).astype(np.float32)
    c = (rng.uniform(-1e7, 1e7, 400) * 10.0 ** rng.integers(-6, 3, 400)).astype(np.float32)
    a[0], b[0], c[0] = 29.5, np.float32(8.677966117858887), 2.0 ** 32
    got = np.array([T.fma_f32(torch.tensor([x]), float(y), float(z)).item()
                    for x, y, z in zip(a, b, c)], np.float32)
    want = np.array([rounded(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 2.0 ** 32 + 512
    assert np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0])) == 2.0 ** 32
    grid = T.GridSpec(-317.5, -123.25, 37.3, 61.1, 11, 5)
    ids = torch.arange(55, dtype=torch.int32)
    fused, unfused = T.cell_centres(grid, ids, fused=True), T.cell_centres(grid, ids)
    assert any(not torch.equal(f, u) for f, u in zip(fused, unfused))


def test_apply_spots_overlay():
    grid = GRIDS["8x8"]
    rng = np.random.default_rng(5)
    jq, tq = queries(grid, 30, rng, with_spots=True)
    hit = rng.random((30, grid.num_cells)) < 0.5
    dist = rng.integers(0, 9, (30, grid.num_cells)).astype(np.int32)
    for a, b in zip(J.apply_spots_overlay(j(hit), j(dist), jq),
                    T.apply_spots_overlay(t(hit), t(dist), tq)):
        assert_same(a, b)


def test_damping_intervals_and_fanout_due():
    rng = np.random.default_rng(6)
    dist = rng.integers(0, 8, (20, 30)).astype(np.int32)
    interest = rng.random((20, 30)) < 0.6
    tiers = np.array([0, 2, 5], np.int32)
    tier_iv = np.array([20, 50, 100], np.int32)
    assert_same(
        J.damping_intervals_ms(j(dist), j(interest), j(tiers), j(tier_iv), 200),
        T.damping_intervals_ms(t(dist), t(interest), t(tiers), t(tier_iv), 200),
    )
    last = rng.integers(0, 500, 300).astype(np.int32)
    interval = rng.integers(20, 200, 300).astype(np.int32)
    active = rng.random(300) < 0.8
    for a, b in zip(J.fanout_due(jnp.int32(400), j(last), j(interval), j(active)),
                    T.fanout_due(400, t(last), t(interval), t(active))):
        assert_same(a, b)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 64, 1001])
def test_packbits_is_numpy_packbits(n):
    bits = np.random.default_rng(n).random(n) < 0.4
    packed = T.packbits(t(bits))
    assert packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), np.packbits(bits))


@pytest.mark.parametrize("with_spots", [False, True])
@pytest.mark.parametrize("name", GRIDS)
def test_spatial_step_dict_and_consume_blob(name, with_spots):
    """The whole step dict, key by key, and the parsed consume blob —
    with a row budget small enough to overflow."""
    grid = GRIDS[name]
    rng = np.random.default_rng(7)
    n, s, max_ho = 700, 77, 16
    pos = positions(grid, n, rng)
    valid = rng.random(n) > 0.1
    prev = np.where(rng.random(n) < 0.7, rng.integers(-1, grid.num_cells, n), -1).astype(np.int32)
    last = rng.integers(0, 300, s).astype(np.int32)
    interval = rng.integers(33, 200, s).astype(np.int32)
    active = rng.random(s) < 0.8
    jq, tq = queries(grid, 29, rng, with_spots)
    jout = J.spatial_step(grid, j(pos), j(prev.copy()), j(valid), jq,
                          (j(last), j(interval), j(active)), max_ho, jnp.int32(250))
    tout = T.spatial_step(grid, t(pos), t(prev), t(valid), tq,
                          (t(last), t(interval), t(active)), max_ho, 250)
    assert set(jout) == set(tout)
    for key in jout:
        assert_same(jout[key], tout[key])
    assert int(tout["handover_count"]) > max_ho  # the overflow path ran
    jp = J.parse_consume_blob(np.asarray(jout["consume"]), max_ho, grid.num_cells, s)
    tp = T.parse_consume_blob(tout["consume"].numpy(), max_ho, grid.num_cells, s)
    assert jp[0] == tp[0]
    for a, b in zip(jp[1:], tp[1:]):
        assert np.array_equal(a, b)


def test_spatial_step_accepts_any_grid_object():
    """Any object with the six GridSpec fields works (the JAX package's
    GridSpec and the port's own give the same step)."""
    jgrid = GRIDS["8x8"]
    tgrid = T.GridSpec(*jgrid)
    rng = np.random.default_rng(8)
    pos, valid = positions(jgrid, 50, rng), np.ones(50, bool)
    prev = np.full(50, -1, np.int32)
    _, tq = queries(jgrid, 5, rng, False)
    sub = (t(np.zeros(4, np.int32)), t(np.full(4, 10, np.int32)), t(np.ones(4, bool)))
    a = T.spatial_step(jgrid, t(pos), t(prev), t(valid), tq, sub, 8, 5)
    b = T.spatial_step(tgrid, t(pos), t(prev), t(valid), tq, sub, 8, 5)
    assert all(torch.equal(a[k], b[k]) for k in a)
