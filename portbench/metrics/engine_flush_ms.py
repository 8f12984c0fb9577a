"""engine_flush_ms: the engine's flush of the host's staged rows to the
device inside its tick (the program's ``engine.flush`` span), mean a step."""

from portbench.core.program import mean_ms


def read(rec):
    return mean_ms(rec, ("engine.flush",))
