"""step_p95_ms.sidecar: the 95th percentile of the sidecar's steps (request
bytes in hand to response bytes out) over the traced window's steps outside
its profiled stretches."""

from portbench.metrics._common import percentile


def read(rec):
    return percentile([s["lat_ms"] for s in rec.get("steps_a", [])], 95)
