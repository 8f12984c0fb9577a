"""ingest_ns_per_update: the time in the program's ``sidecar.ingest`` spans
over the updates and removals they count."""

from portbench.core.program import ns_per_count


def read(rec):
    return ns_per_count(rec, "sidecar.ingest")
