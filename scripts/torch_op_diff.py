#!/usr/bin/env python3
"""Which torch ops of the port's sim step round differently on the CPU
and on CUDA.

    python3 scripts/torch_op_diff.py

Needs one CUDA card. Builds the sim world's first tick (the 64x64 grid
of 100 m cells, 100,000 agents at rest from ``default_rng(20)`` in
1<<17 slots, a 64-cell flee mask; as ``chip_smoke.py`` phase 5), runs
one ``sim_step`` on the CPU and on the card from the same state while a
``TorchFunctionMode`` records every torch call's inputs and outputs,
and prints each call whose outputs differ although its inputs are
equal. The sim columns are bit-identical on both devices; the float64
roots inside ``sqrt_rn`` may differ in their last bit and still round
to the same float32. It also counts how many float32 square roots of 2^20
seeded uniform inputs in [0, 1e4) ``torch.sqrt`` gets wrong on each
device, against the float64 root rounded once (``spatial_ops.sqrt_rn``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from channeld_tpu_torch.ops import spatial_ops as T  # noqa: E402


class Recorder(TorchFunctionMode):
    """Keeps (name, tensor inputs, tensor outputs) of every torch call,
    copied to the host (cloned: ``cpu()`` of a CPU tensor is the tensor
    itself, which a later in-place op would change)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.calls.append((
            getattr(func, "__name__", str(func)),
            [a.detach().cpu().clone() for a in args if isinstance(a, torch.Tensor)],
            [o.detach().cpu().clone() for o in outs if isinstance(o, torch.Tensor)],
        ))
        return out


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    if a.dtype == torch.float64:
        return torch.equal(a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))
    return torch.equal(a, b)


def first_tick_state():
    rng = np.random.default_rng(20)
    cap, n = 1 << 17, 100_000
    pos = np.zeros((cap, 3), np.float32)
    pos[:n, 0] = rng.uniform(1.0, 6399.0, n)
    pos[:n, 2] = rng.uniform(1.0, 6399.0, n)
    agent = np.zeros(cap, bool)
    agent[:n] = True
    flee = np.zeros(64 * 64, bool)
    flee[rng.choice(flee.size, 64, replace=False)] = True
    return (pos, np.zeros((cap, 3), np.float32), np.zeros(cap, np.int32), pos.copy(),
            agent, flee)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_op_diff: no CUDA device", file=sys.stderr)
        return 2
    grid = T.GridSpec(0.0, 0.0, 100.0, 100.0, 64, 64)
    params = T.SimParams(dt=0.05, max_speed=6.0, accel=24.0, separation=0.6, cohesion=0.15,
                         arrive_radius=1.5, crowd=32, p_wander=0.2, p_seek=0.1, p_idle=0.05)
    state = first_tick_state()
    calls = {}
    for dev in ("cpu", "cuda"):
        rec = Recorder()
        with rec:
            T.sim_step(grid, *(torch.from_numpy(a).to(dev) for a in state), params, 20, 0)
        calls[dev] = rec.calls
    print(f"torch calls in one sim_step: {len(calls['cpu'])} on the CPU, "
          f"{len(calls['cuda'])} on cuda ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__})")
    differing = 0
    for i, ((name, ins_c, outs_c), (_, ins_g, outs_g)) in enumerate(zip(calls["cpu"],
                                                                        calls["cuda"])):
        inputs_equal = all(bits_equal(a, b) for a, b in zip(ins_c, ins_g))
        if inputs_equal and not all(bits_equal(a, b) for a, b in zip(outs_c, outs_g)):
            differing += 1
            rows = sum(int((a != b).reshape(len(a), -1).any(1).sum())
                       for a, b in zip(outs_c, outs_g) if a.dim())
            print(f"call {i} {name}: equal inputs, outputs differ in {rows} rows")
    print(f"calls whose outputs differ on equal inputs: {differing}")
    s = torch.from_numpy(np.random.default_rng(0).uniform(0, 1e4, 1 << 20).astype(np.float32))
    want = T.sqrt_rn(s)
    for dev in ("cpu", "cuda"):
        wrong = int((torch.sqrt(s.to(dev)).cpu() != want).sum())
        print(f"torch.sqrt float32 on {dev}: {wrong} of {s.numel()} uniform [0, 1e4) inputs "
              f"differ from the correctly rounded root")
    return 0


if __name__ == "__main__":
    sys.exit(main())
