"""The sidecar's request generator, run as a child process.

    python -m portbench.gen.sidecar_child SEED CONFIG MIX   # CONFIG and MIX as JSON text

Writes one frame a step to standard output, from step 0 on: a header of two
little-endian uint32 (the payload's length, the live entities once the step
is applied) and the StepRequest's bytes. It generates the next step while
the consumer works on the last, and ends when the consumer closes the pipe.
Imports numpy and this benchmark's generator, nothing of the program.
"""

from __future__ import annotations

import json
import os
import struct
import sys


def main(argv) -> None:
    from ..core import wire
    from .sidecar_load import Load

    seed = int(argv[0])
    config = json.loads(argv[1])
    mix = json.loads(argv[2])
    load = Load(seed, config["grid"], mix)
    out = sys.stdout.buffer
    step = 0
    try:
        while True:
            st = load.step(step)
            payload = wire.step_request(st)
            out.write(struct.pack("<II", len(payload), st.live_entities))
            out.write(payload)
            out.flush()
            step += 1
    except (BrokenPipeError, ValueError, OSError):
        pass
    os._exit(0)  # the consumer is gone: nothing left to flush


if __name__ == "__main__":
    main(sys.argv[1:])
