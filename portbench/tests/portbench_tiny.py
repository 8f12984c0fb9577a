"""Tiny sizes of each cell for runs on the CPU (the shapes of the cell, its
scale cut), and a helper that runs one."""

from __future__ import annotations

SIDECAR = {"config": {"entity_capacity": 4096, "query_capacity": 128, "sub_capacity": 1024},
           "mix": {"entities": 2000, "queries": 64, "subscriptions": 256, "burst_entities": 300,
                   "query_changes": 8, "conn_churn": 2, "sub_churn": 10, "entity_churn": 5}}
CROWD = {"config": {"entity_capacity": 4096, "query_capacity": 128, "query_rows_max": 256,
                    "census_every": 20},
         "mix": {"agents": 3000, "followers": 32, "sensors": 64, "subscriptions": 128,
                 "flee_every": 60, "spots_every": 8}}
SIZES = {"sidecar.bench100k.all_moving": SIDECAR, "crowd.sim100k": CROWD}


def run(workload: str, seed: int = 5, seconds: float = 1.0, trace: bool = False):
    from portbench.core import harness

    return harness.run(workload, seed, seconds, trace, device="cpu", overrides=SIZES[workload])
