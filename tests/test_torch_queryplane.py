"""The standing-query diff of channeld_tpu_torch against channeld_tpu.

``diff_query_masks`` and ``parse_query_blob`` on the same seeded masks
in both packages (the port on the CPU), exact; the mirror protocol's
reconstruction property and the overflow drain on the port; and the
engine's tracking path: one changed-rows transfer per tick, baselines
reset on row reuse, rows equal to the JAX engine's tick by tick.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from channeld_tpu.ops import spatial_ops as J
from channeld_tpu.ops.engine import SpatialEngine as JaxEngine
from channeld_tpu_torch.ops import spatial_ops as T
from channeld_tpu_torch.ops.engine import SpatialEngine

GRID = T.GridSpec(-400.0, -400.0, 100.0, 100.0, 8, 8)
CAPS = dict(entity_capacity=48, query_capacity=8, sub_capacity=8, max_handovers=8)


def masks(rng, q, c, p=0.3):
    return rng.random((q, c)) < p, rng.integers(0, 4, (q, c)).astype(np.int32)


DIFF_CASES = [(7, 13, 4096), (7, 13, 5), (7, 13, 1), (16, 64, 100), (3, 8, 24)]


@pytest.mark.parametrize("q,c,max_rows", DIFF_CASES)
def test_diff_query_masks_matches_jax(q, c, max_rows):
    """Six ticks of masks (the first against the empty baseline): the
    blob, both committed baselines and the parsed rows exact."""
    rng = np.random.default_rng(q * 1000 + c + max_rows)
    prev_j = (jnp.zeros((q, c), bool), jnp.zeros((q, c), jnp.int32))
    prev_t = (torch.zeros((q, c), dtype=torch.bool), torch.zeros((q, c), dtype=torch.int32))
    for _ in range(6):
        interest, dist = masks(rng, q, c)
        blob_j, *prev_j = J.diff_query_masks(*prev_j, jnp.asarray(interest),
                                             jnp.asarray(dist), max_rows)
        blob_t, *prev_t = T.diff_query_masks(*prev_t, torch.from_numpy(interest),
                                             torch.from_numpy(dist), max_rows)
        assert blob_t.dtype == torch.int32
        assert np.array_equal(blob_t.numpy(), np.asarray(blob_j))
        for a, b in zip(prev_t, prev_j):
            assert np.array_equal(a.numpy(), np.asarray(b))
        count_j, rows_j = J.parse_query_blob(np.asarray(blob_j))
        count_t, rows_t = T.parse_query_blob(blob_t.numpy())
        assert count_t == count_j and np.array_equal(rows_t, rows_j)


def test_diff_reconstruction_property():
    """Replaying every changed row against a host mirror reconstructs
    the device's full interest/dist planes exactly, tick after tick."""
    rng = np.random.default_rng(3)
    q, c = 7, 13
    prev = (torch.zeros((q, c), dtype=torch.bool), torch.zeros((q, c), dtype=torch.int32))
    recon_i = np.zeros((q, c), bool)
    recon_d = np.zeros((q, c), np.int32)
    for _ in range(6):
        interest, dist = masks(rng, q, c)
        blob, *prev = T.diff_query_masks(*prev, torch.from_numpy(interest),
                                         torch.from_numpy(dist), 4096)
        count, rows = T.parse_query_blob(blob.numpy())
        assert count <= q * c
        for qi, ci, d in rows[:count].tolist():
            recon_i[qi, ci] = d >= 0
            if d >= 0:
                recon_d[qi, ci] = d
        np.testing.assert_array_equal(recon_i, interest)
        np.testing.assert_array_equal(recon_d[recon_i], dist[recon_i])


def test_diff_overflow_rediffs_until_drained():
    """Rows past the budget keep their previous baseline, so repeating
    the same masks drains the backlog a budget's worth per tick; nothing
    is lost or emitted twice, and count is always the true backlog."""
    q, c = 3, 8
    interest = np.arange(q * c).reshape(q, c) % 2 == 0
    dist = np.ones((q, c), np.int32)
    total = int(interest.sum())
    prev = (torch.zeros((q, c), dtype=torch.bool), torch.zeros((q, c), dtype=torch.int32))
    recon = np.zeros((q, c), bool)
    seen = 0
    for _ in range((total + 3) // 4 + 1):
        blob, *prev = T.diff_query_masks(*prev, torch.from_numpy(interest),
                                         torch.from_numpy(dist), 4)
        count, rows = T.parse_query_blob(blob.numpy())
        assert count == total - seen
        emitted = rows[: min(count, len(rows))].tolist()
        for qi, ci, d in emitted:
            assert d >= 0 and not recon[qi, ci], "row emitted twice"
            recon[qi, ci] = True
        seen += len(emitted)
        if count == 0:
            break
    np.testing.assert_array_equal(recon, interest)


def test_max_rows_is_clamped_to_the_plane():
    blob, _, _ = T.diff_query_masks(torch.zeros((2, 3), dtype=torch.bool),
                                    torch.zeros((2, 3), dtype=torch.int32),
                                    torch.ones((2, 3), dtype=torch.bool),
                                    torch.zeros((2, 3), dtype=torch.int32), 8192)
    count, rows = T.parse_query_blob(blob.numpy())
    assert count == 6 and rows.shape == (6, 3)
    assert rows.tolist() == [[0, 0, 0], [0, 1, 0], [0, 2, 0], [1, 0, 0], [1, 1, 0], [1, 2, 0]]


# ---- through the engine ---------------------------------------------------------


def script(engines, rng, tick):
    """Queries set, moved, removed and re-added (row reuse) in both."""
    ops = []
    if tick == 0:
        for conn in range(1, 6):
            ops.append(("set_query", conn, int(rng.integers(1, 4)),
                        tuple(float(v) for v in rng.uniform(-350, 350, 2)),
                        tuple(float(v) for v in rng.uniform(40, 220, 2)),
                        (1.0, 0.0), 0.8))
        ops.append(("set_spots_query", 9, [(10.0, 10.0), (-250.0, 130.0)], [2]))
    else:
        conn = int(rng.integers(1, 6))
        ops.append(("set_query", conn, int(rng.integers(1, 4)),
                    tuple(float(v) for v in rng.uniform(-350, 350, 2)),
                    tuple(float(v) for v in rng.uniform(40, 220, 2)), (0.0, 1.0), 0.6))
    if tick == 3:
        ops.append(("remove_query", 2))
    if tick == 4:  # a new connection takes the freed row
        ops.append(("set_query", 20, T.AOI_BOX, (0.0, 0.0), (150.0, 150.0), (1.0, 0.0), 0.0))
    for op in ops:
        for eng in engines:
            getattr(eng, op[0])(*op[1:])


def test_engine_rows_equal_jax_and_one_transfer_per_tick(monkeypatch):
    jax_eng = JaxEngine(J.GridSpec(*GRID), query_rows_max=6, **CAPS)
    port = SpatialEngine(GRID, device="cpu", query_rows_max=6, **CAPS)
    for eng in (jax_eng, port):
        eng.track_query_changes = True
    rng = np.random.default_rng(8)
    fetched = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: fetched.append(t) or real(t, *a, **k))
    backlog = False
    for tick in range(8):
        script([jax_eng, port], rng, tick)
        want = jax_eng.query_changed_rows(jax_eng.tick(100 + 33 * tick))
        out = port.tick(100 + 33 * tick)
        fetched.clear()
        got = port.query_changed_rows(out)
        again = port.query_changed_rows(out)
        assert len(fetched) == 1  # the blob, once, cached on the result
        assert got[0] == want[0] == again[0]
        assert np.array_equal(got[1], want[1])
        assert out["query_epoch"] == 0
        backlog |= got[0] > 6
    assert backlog
    assert port._q_prev_reset_rows == set() == jax_eng._q_prev_reset_rows


def test_tracking_off_has_no_rows_and_reset_rows_are_cleared():
    port = SpatialEngine(GRID, device="cpu", **CAPS)
    port.set_query(1, T.AOI_SPHERE, (0.0, 0.0), (100.0, 0.0))
    assert port._q_prev_reset_rows == {port.query_row_of_conn(1)}
    out = port.tick(10)
    count, rows = port.query_changed_rows(out)
    assert count == 0 and rows.shape == (0, 3)
    assert port._q_prev_reset_rows == set() and port._d_q_prev is None
