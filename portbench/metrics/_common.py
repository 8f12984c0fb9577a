"""Arithmetic the readers share."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float):
    """The q-th percentile (linear interpolation between ranks), or None."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def mean(values):
    values = list(values)
    return float(np.mean(values)) if values else None


def top_ms(events, prefix: str) -> float:
    """Milliseconds in spans named ``prefix``* whose parent is not one of
    them (nested calls counted once)."""
    return sum((e.t1 - e.t0) * 1e3 for e in events
               if e.name.startswith(prefix) and not e.parent.startswith(prefix))


def roofline(rec: dict, kernel: str, bound_ms: float):
    """The least time over the kernel's mean profiled time a launch, %."""
    times = rec.get("device", {}).get("kernel_ms", {}).get(kernel)
    if not times:
        return None
    return 100.0 * bound_ms / float(np.mean(times))


def span_device_ms(rec: dict, name: str):
    got = rec.get("span_device", {}).get(name)
    steps = rec.get("span_device_steps")
    if not got or not got[1] or not steps or got[0] <= 0:
        return None
    return got[0] / steps
