"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (the tiny sizes run on the CPU);
the rest of a run goes as on the chip. Each fault that a cell can have:
a step that leaves its state unchanged, half of the batch left out, an
answer altered where it is produced. (The exchange between chips: no cell
runs on more than one.)"""

from __future__ import annotations

import pytest
import torch

import portbench_tiny as tiny


def _unchanged(monkeypatch):
    """The engine's step keeps last tick's committed cells and the sim pass
    returns its state as it found it."""
    from channeld_tpu_torch.ops import engine

    step, sim = engine.spatial_step, engine.sim_step

    def stale_step(grid, positions, prev_cell, *args, **kwargs):
        out = step(grid, positions, prev_cell, *args, **kwargs)
        out["committed_prev"] = prev_cell
        return out

    def stale_sim(grid, positions, vel, state, target, *args, **kwargs):
        return positions, vel, state, target

    monkeypatch.setattr(engine, "spatial_step", stale_step)
    monkeypatch.setattr(engine, "sim_step", stale_sim)


def _half(monkeypatch):
    """Every other entity update is dropped, and the sim pass moves only
    the first half of the slots."""
    from channeld_tpu_torch.ops import engine

    update, sim = engine.SpatialEngine.update_entity, engine.sim_step
    calls = {"n": 0}

    def half_update(self, *args):
        calls["n"] += 1
        if calls["n"] % 2 or args[0] not in self._slot_of_entity:
            update(self, *args)

    def half_sim(grid, positions, vel, state, target, *args, **kwargs):
        new = sim(grid, positions, vel, state, target, *args, **kwargs)
        h = positions.shape[0] // 2
        return tuple(torch.cat([n[:h], o[h:]]) for n, o in zip(new, (positions, vel, state,
                                                                      target)))

    monkeypatch.setattr(engine.SpatialEngine, "update_entity", half_update)
    monkeypatch.setattr(engine, "sim_step", half_sim)


def _altered(monkeypatch):
    """One cell's count is off by one in the tick's blob, where the step
    produces it."""
    from channeld_tpu_torch.ops import engine

    step = engine.spatial_step

    def altered(grid, *args, **kwargs):
        out = step(grid, *args, **kwargs)
        blob = out["consume"].clone()
        blob[1 + 3 * out["handovers"].shape[0] + 3] += 1
        out["consume"] = blob
        return out

    monkeypatch.setattr(engine, "spatial_step", altered)


@pytest.mark.parametrize("workload", sorted(tiny.SIZES))
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny.run(workload, seed=3)
    assert out["correct"] is False, out["checks"]
