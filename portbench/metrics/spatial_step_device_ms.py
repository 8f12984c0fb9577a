"""spatial_step_device_ms: device time a step of the kernels launched
inside spatial_step (K1, K2 and the ops around them)."""

from portbench.metrics._common import span_device_ms


def read(rec):
    return span_device_ms(rec, "engine.spatial_step")
