"""Seeded inputs of the device crowd, and its per-tick schedule.

A frozen copy of ``chip_smoke.py``'s ``SimWorld`` drive (lines 1210-1290 of
the tree this benchmark was written against: scripts/sim_bench.py's world
with the standing-query plane armed), driven by a mix's parameters:

- agents spawn uniformly over the world, at rest, idle, each aimed at its
  own position;
- ``followers`` sphere queries (radius ``follower_radius``) follow seeded
  agents; each tick re-centres them on the host's shadow of their agent,
  which the census refreshes;
- ``sensors`` box and cone queries (extents ``sensor_extent``, cone
  half-angle ``sensor_angle``), one spots query in ``spots_every``;
- ``subscriptions`` at ``sub_interval`` ms, first due within ``sub_first``;
- two seeded sets of ``flee_cells`` cells, the flee mask switching between
  them every ``flee_every`` ticks (a panic wave).

No agent leaves or joins: the population is ``scripts/sim_bench.py``'s for
the whole window. Its random waypoints draw agents into the middle of the
world, so the crossings a tick grow as the run goes on.

The same seed gives the same world; nothing here knows the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Sensor(NamedTuple):
    conn: int
    kind: int  # 2 box, 3 cone, 4 spots
    x: float
    z: float
    ex: float
    ez: float


class CrowdWorld(NamedTuple):
    ids: np.ndarray  # entity ids of the agents, in spawn order
    xs: np.ndarray  # float64 spawn positions
    zs: np.ndarray
    followed: np.ndarray  # indices into the agents
    sensors: list
    sub_interval: np.ndarray
    sub_first: np.ndarray
    flee: list  # two lists of cells


BOX, CONE, SPOTS = 2, 3, 4


def build(seed: int, grid: dict, mix: dict) -> CrowdWorld:
    n = int(mix["agents"])
    world_x = grid["cols"] * grid["cell_w"]
    world_z = grid["rows"] * grid["cell_h"]
    rng = np.random.default_rng(seed)
    xs = rng.uniform(grid["offset_x"] + 1.0, grid["offset_x"] + world_x - 1.0, n)
    zs = rng.uniform(grid["offset_z"] + 1.0, grid["offset_z"] + world_z - 1.0, n)
    q = np.random.default_rng([seed, 1])
    followed = q.choice(n, int(mix["followers"]), replace=False)
    lo_e, hi_e = mix["sensor_extent"]
    sensors = []
    every = int(mix["spots_every"])
    for i in range(int(mix["sensors"])):
        x, z = (float(v) for v in q.uniform(0.0, 1.0, 2))
        x = grid["offset_x"] + x * world_x
        z = grid["offset_z"] + z * world_z
        if every and i % every == every - 1:
            sensors.append(Sensor(10_000 + i, SPOTS, x, z, 0.0, 0.0))
        else:
            sensors.append(Sensor(10_000 + i, (BOX, CONE)[i % 2], x, z,
                                  float(q.uniform(lo_e, hi_e)), float(q.uniform(lo_e, hi_e))))
    lo_i, hi_i = mix["sub_interval"]
    ns = int(mix["subscriptions"])
    interval = q.integers(lo_i, hi_i + 1, ns)
    first = q.integers(0, int(mix["sub_first"]), ns)
    cells = int(grid["cols"]) * int(grid["rows"])
    flee = [q.choice(cells, int(mix["flee_cells"]), replace=False).tolist() for _ in range(2)]
    ids = np.arange(n, dtype=np.int64) + int(mix["first_entity_id"])
    return CrowdWorld(ids, xs, zs, followed, sensors, interval, first, flee)


def flee_set(mix: dict, tick: int):
    """Which flee set (0 or 1) a tick switches to, or None."""
    every = int(mix["flee_every"])
    if tick == 0:
        return 0
    if every and tick % every == 0:
        return (tick // every) % 2
    return None


def census_due(config: dict, tick: int) -> bool:
    """A census every ``census_every`` ticks (the configuration's), at
    ticks ``census_phase`` modulo it."""
    return tick % int(config["census_every"]) == int(config["census_phase"])


def now_ms(tick: int) -> int:
    return 1000 + 33 * tick
