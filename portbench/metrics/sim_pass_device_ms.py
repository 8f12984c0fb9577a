"""sim_pass_device_ms: device time a tick of the kernels launched inside
channeld_tpu_torch.ops.engine.sim_step."""

from portbench.metrics._common import span_device_ms


def read(rec):
    return span_device_ms(rec, "engine.sim_step")
