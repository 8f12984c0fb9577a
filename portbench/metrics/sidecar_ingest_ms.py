"""sidecar_ingest_ms: the sidecar's ingest of a step's position updates and
removals (the program's ``sidecar.ingest`` span), mean a step."""

from portbench.core.program import mean_ms


def read(rec):
    return mean_ms(rec, ("sidecar.ingest",))
