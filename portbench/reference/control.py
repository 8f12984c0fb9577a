"""The control: the reference in bfloat16 put in the program's place.

    python3 -m portbench.reference.control --workload <cell> --steps N --seeds A B C

For each seed, runs the cell's traffic through the float32 reference and
through the same reference with its positions held in bfloat16 (the
precision below the float32 the configurations state), and prints the
numbers the cell's check compares, as the control reads them. A sound check
reads them above its limit on every seed. Needs no card (NumPy only); runs
at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def as_decision(d):
    """A reference decision in the shape of a decoded StepResponse."""
    from ..core.wire import Decision

    interests = {}
    for conn, (strict, _, dist) in d.interests.items():
        cells = np.nonzero(strict)[0]
        interests[conn] = (cells.astype(np.int64), dist[cells].astype(np.int64))
    return Decision(d.handovers, d.handover_count, d.cell_counts, interests, d.due_sub_ids,
                    0, "")


def sidecar_readings(config: dict, mix: dict, seed: int, steps: int) -> dict:
    from ..gen.sidecar_load import Load
    from .sidecar_ref import SidecarRef, compare

    sides = []
    for precision in ("f32", "bf16"):
        load = Load(seed, config["grid"], mix)
        ref = SidecarRef(config["grid"], config["entity_capacity"], config["query_capacity"],
                         config["sub_capacity"], config["max_handovers"], precision)
        sides.append([ref.apply(load.step(i)) for i in range(steps)])
    wrong = sum(bool(compare(as_decision(c), w)[0]) for w, c in zip(*sides))
    return {"steps_wrong": wrong}


def crowd_readings(config: dict, mix: dict, seed: int, ticks: int) -> dict:
    from .crowd_ref import CrowdRef, census_bits_wrong, compare_tick

    want, got = CrowdRef(seed, config, mix), CrowdRef(seed, config, mix, "bf16")
    wrong = bits = 0
    for t in range(ticks):
        a, b = got.tick(t), want.tick(t)
        diffs = compare_tick(a, b)
        if "census" in a and "census" in b:
            n = census_bits_wrong(a["census"], b["census"])
            bits += n
            diffs += ["census"] if n else []
        wrong += bool(diffs)
    return {"ticks_wrong": wrong, "census_elements_wrong": bits}


def readings(workload: str, seed: int, steps: int, overrides=None) -> dict:
    from ..core.harness import benchmark, find_cell

    _, config, mix = find_cell(benchmark(), workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    if config["driver"] == "crowd":
        return crowd_readings(config, mix, seed, steps)
    return sidecar_readings(config, mix, seed, steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(args.workload, seed, args.steps)
        print(json.dumps(dict(workload=args.workload, seed=seed, steps=args.steps,
                              control=got, seconds=round(time.perf_counter() - t0, 1))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
