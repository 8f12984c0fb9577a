"""Metric readers, one file a metric, loaded by path under the metric's name.

Each defines ``read(rec)``: the metric's value from a run's record, or None
where the record holds nothing to read (the harness then leaves the metric
out). An untraced run's record holds ``setup_s``, ``window_s`` and, for
every decision of the window, ``latency_ms`` and ``live`` (entities covered).
A traced run's adds ``steps_a`` (per step outside the trace's stretches: its
latency and the benchmark's spans), ``reads``, ``device`` (the device-only
profile: busy, wall, kernel durations, idle gaps) and ``span_device`` (device
time inside the device spans), and ``shapes`` (the kernels' launch shapes).
"""
