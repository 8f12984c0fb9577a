"""sidecar_reply_ms: the sidecar's shaping of a step's reply, the program's
``sidecar.interest`` (the reported connections' interest rows, read and
mapped), ``sidecar.due`` (the slot to subscription mapping) and
``sidecar.respond`` (the StepResponse built) spans, mean a step."""

from portbench.core.program import mean_ms


def read(rec):
    return mean_ms(rec, ("sidecar.interest", "sidecar.due", "sidecar.respond"))
