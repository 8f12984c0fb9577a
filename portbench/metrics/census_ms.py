"""census_ms: host time of a census tick's fetch of the four sim columns and
their absorption into the host's shadow, mean over census ticks."""

from portbench.metrics._common import mean


def read(rec):
    return mean(sum((e.t1 - e.t0) * 1e3 for e in s["events"] if e.name == "crowd.census")
                for s in rec.get("steps_a", [])
                if any(e.name == "crowd.census" for e in s["events"]))
