"""The port's benchmark: one cell of BENCHMARK.json a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, entry driver or
per-layer metric sits in a file of its own, found by the name that
BENCHMARK.json gives it: ``configs/<config>.json``, ``traffic/<mix>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py``. The yardstick (traffic
generation, the readings of spans and traces, the table of peaks, the
kernels' bytes and operations, the plain references and the comparison that
decides ``correct``) lives here and imports nothing of the JAX package; it
drives ``channeld_tpu_torch`` only through its entry points.
"""
