"""engine_tick_ms: the engine's tick and its readbacks (flush, step,
consume, interest rows or changed rows, handovers), mean a step."""

from portbench.metrics._common import mean, top_ms


def read(rec):
    return mean(top_ms(s["events"], "engine.") for s in rec.get("steps_a", []))
