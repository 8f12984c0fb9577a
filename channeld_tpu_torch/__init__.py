"""channeld-tpu's gateway and spatial decision plane on PyTorch and CUDA.

The port of ``channeld_tpu`` (JAX, TPU) to an NVIDIA H100. Module names
mirror the JAX package's so each counterpart is easy to find. The
gateway's host layers (``core``, ``chaos``, ``federation``,
``protocol``, ``spatial``, ``sim``, ``client`` and the rest) are copies
of the JAX package's, held byte-identical by
``tests/test_torch_copies.py``; the device planes (``ops``), the spatial
controller (``spatial/gpu_controller.py``), the device guard and the
profiler are ported. This package imports torch, numpy, the standard
library and the host libraries the copies use (protobuf,
prometheus_client): nothing of ``jax`` and nothing of ``channeld_tpu``.
Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``-spatial-device cpu``; see ``utils/devices.py``).

    python -m channeld_tpu_torch -dev -scc config/spatial_tpu_benchmark.json
"""
