"""assign_count_roofline: K1's least time at the cell's launch shape (every
entity slot, every cell; bytes / 3.35 TB/s against float ops / 67 TFLOP/s)
over its mean profiled time a launch, %."""

from portbench.core.devtime import assign_count_bound_ms
from portbench.metrics._common import roofline


def read(rec):
    slots, cells = rec["shapes"]["assign_count"]
    return roofline(rec, "assign_count", assign_count_bound_ms(slots, cells)[0])
