"""aoi_roofline: K2's least time at the cell's launch shape (every query row,
every cell) over its mean profiled time a launch, %."""

from portbench.core.devtime import aoi_bound_ms
from portbench.metrics._common import roofline


def read(rec):
    queries, cols, rows = rec["shapes"]["aoi"]
    return roofline(rec, "aoi", aoi_bound_ms(queries, cols, rows)[0])
