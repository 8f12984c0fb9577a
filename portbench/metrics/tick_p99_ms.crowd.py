"""tick_p99_ms.crowd: the 99th percentile of the crowd's ticks (from the start
of a tick's drive to its readbacks in hand, census ticks included) over the
traced window's ticks outside its profiled stretches."""

from portbench.metrics._common import percentile


def read(rec):
    return percentile([s["lat_ms"] for s in rec.get("steps_a", [])], 99)
