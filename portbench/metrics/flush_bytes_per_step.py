"""flush_bytes_per_step: the bytes of the host arrays the engine's flush
copied to the device (the count on the program's ``engine.flush`` span),
mean a step."""

from portbench.core.program import mean_count


def read(rec):
    return mean_count(rec, "engine.flush")
