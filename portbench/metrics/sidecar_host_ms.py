"""sidecar_host_ms: a step's host time outside the engine's spans (parse,
ingest, the due mapping, the response and its bytes), mean a step."""

from portbench.metrics._common import mean, top_ms


def read(rec):
    return mean(s["lat_ms"] - top_ms(s["events"], "engine.") for s in rec.get("steps_a", []))
