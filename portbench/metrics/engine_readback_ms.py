"""engine_readback_ms: the host's reads of a tick's results (the program's
``engine.read.*`` spans: the consume blob, interest rows, changed query
rows), mean a step."""

from portbench.core.program import mean_ms


def read(rec):
    return mean_ms(rec, ("engine.read.",))
