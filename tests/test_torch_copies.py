"""Copy fidelity: the port's host layers are the JAX package's code.

Every module of ``channeld_tpu_torch`` that has a counterpart at the
same path in ``channeld_tpu`` and is not in ``EDITED`` below must be
byte-identical to it once ``channeld_tpu.`` is rewritten to
``channeld_tpu_torch.`` in absolute imports and in the module name the
generated ``*_pb2`` files hand to ``BuildTopDescriptorsAndMessages``. So
the JAX package's own tests of its host layers vouch for the copies.
Every ``*_pb2`` descriptor must be byte-identical too: protobuf's
default pool then holds one file for both packages, and their message
classes are the same objects.
"""

import importlib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = "channeld_tpu_torch", "channeld_tpu"

# Modules with a counterpart that the port edits, each with why.
EDITED = {
    "__init__.py": "the port's own package docstring",
    "__main__.py": "no pin of JAX to the CPU before the gateway starts",
    "core/settings.py": "-spatial-device (the engine's torch device); -profile gpu in the help",
    "core/profiling.py": "-profile gpu is torch.profiler, not jax.profiler",
    "core/device_guard.py": "reads a tick through the consume blob; torch failure classes "
                            "(torch imported by the calls that need it, F27); "
                            "enters the engine's CUDA device on the worker; hands the rebuild "
                            "the host tables copied on the loop thread; says when FAILED "
                            "is terminal",
    "core/wal.py": "a replay's re-tracked entities get their device baseline cell (F23); a "
                   "replayed census goes to a sim plane that is live already (F22)",
    "core/data.py": "an update a custom merge took from another message family enters the "
                    "update ring as the channel's own type (F20)",
    "core/opshttp.py": "readiness says a terminal FAILED needs a restart, not a rebuild",
    "core/tracing.py": "a span's count, reading the spans written since a mark, one clock stated",
    "core/channel.py": "the recorder's stamps come from recorder.now(), not a scaled float",
    "core/failover.py": "the rehost span's stamp comes from recorder.now(), not a scaled float",
    "sim/plane.py": "census columns arrive as tensors when the guard is off; a census "
                    "replayed after activation replaces the live population (F22)",
    "sim/authority.py": "reset_pending: a census taken into the live plane drops the attach "
                        "queue (F22)",
    "spatial/__init__.py": "exports GPUSpatialController (tpu_controller.py is not ported)",
    "utils/devices.py": "cuda unless the caller asks for the CPU, never a JAX pin; torch "
                        "imported by the calls (F27)",
    "utils/logger.py": "its own root logger, so both packages' logs stay apart in one process",
    "ops/engine.py": "the engine on torch (ported)",
    "ops/service.py": "the sidecar on the torch engine (ported)",
    "ops/spatial_ops.py": "the device step as torch ops (ported)",
    "parallel/mesh.py": "the entity-sharded step over a list of torch devices (ported)",
    "parallel/spatial_alltoall.py": "the cell-sharded planes over a list of torch devices (ported)",
    "replay/harness.py": "its result also counts the connections dialed and authenticated",
    "native/__init__.py": "builds _codec from the port's codec.cc at first use, logs why not; "
                          "builds and loads step_columns.cc, the sidecar's update decoder",
    "analysis/__init__.py": "the port's tpulint: its driver, gate and baseline",
    "analysis/engine.py": "scans channeld_tpu_torch and chip_smoke.py; the port's baseline file",
    "analysis/threadmodel.py": "the port's module paths and GPUSpatialController",
    "analysis/rules/accounting.py": "the port's metrics module path",
    "analysis/rules/affinity.py": "the port's engine and thread-model paths",
    "analysis/rules/async_blocking.py": "torch's synchronize() in place of block_until_ready",
    "analysis/rules/excepts.py": "the port's hot-path module paths",
    "analysis/rules/proto_drift.py": "the port's schemas, compiled under their shared names",
    "analysis/rules/readback.py": "the port's hot paths; torch's implicit syncs",
    "analysis/rules/units.py": "the port's metrics module path",
}
# The JAX modules the port replaces, each with its replacement.
REPLACED = {
    "ops/pallas_kernels.py": "ops/cuda_kernels.py",
    "parallel/_jax_compat.py": "parallel/spmd.py",
    "spatial/tpu_controller.py": "spatial/gpu_controller.py",
}

_ABSOLUTE = re.compile(rb"^(\s*)(from|import) channeld_tpu\.", re.M)
_PB2_MODULE_ARG = b"BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu."


def port_modules() -> list[str]:
    root = os.path.join(REPO, PORT)
    out = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(out)


def counterparts() -> list[str]:
    return [m for m in port_modules() if os.path.exists(os.path.join(REPO, JAX, m))]


def renamed(source: bytes) -> bytes:
    source = _ABSOLUTE.sub(rb"\1\2 channeld_tpu_torch.", source)
    return source.replace(_PB2_MODULE_ARG, b"BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.")


def read(pkg: str, rel: str) -> bytes:
    with open(os.path.join(REPO, pkg, rel), "rb") as f:
        return f.read()


def test_edited_list_names_real_counterparts():
    """Every edited module exists on both sides and still differs from
    its original: one that no longer needs its edit goes back to being a
    verbatim copy (and leaves this list)."""
    have = set(counterparts())
    for rel in EDITED:
        assert rel in have, rel
        assert renamed(read(JAX, rel)) != read(PORT, rel), f"{rel} is verbatim again"


@pytest.mark.parametrize("rel", [m for m in counterparts() if m not in EDITED])
def test_host_copy_is_byte_identical(rel):
    assert read(PORT, rel) == renamed(read(JAX, rel)), rel


@pytest.mark.parametrize("rel", [m for m in counterparts() if m.endswith("_pb2.py")])
def test_pb2_descriptor_is_byte_identical(rel):
    name = rel[:-3].replace(os.sep, ".")
    port = importlib.import_module(f"{PORT}.{name}")
    jax = importlib.import_module(f"{JAX}.{name}")
    assert port.DESCRIPTOR.serialized_pb == jax.DESCRIPTOR.serialized_pb


def test_the_gateway_closure_is_copied():
    """Every module the JAX gateway's entry point reaches has its
    counterpart in the port, except the device layers the port replaces
    (the TPU controller, the Pallas kernels, the multi-device planes)."""
    import ast

    seen, todo = set(), ["__main__.py", "__init__.py"]
    while todo:
        rel = todo.pop()
        if rel in seen or rel.startswith("parallel/") or rel in REPLACED:
            continue
        seen.add(rel)
        pkg_dir = os.path.dirname(rel)
        for node in ast.walk(ast.parse(read(JAX, rel))):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = pkg_dir.split(os.sep) if pkg_dir else []
                base = base[: len(base) - node.level + 1]
                parts = base + (node.module.split(".") if node.module else [])
                targets = [parts] + [parts + [a.name] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(JAX + "."):
                parts = node.module.split(".")[1:]
                targets = [parts] + [parts + [a.name] for a in node.names]
            else:
                continue
            for parts in targets:
                for cand in ("/".join(parts) + ".py", "/".join(parts + ["__init__.py"])):
                    if os.path.exists(os.path.join(REPO, JAX, cand)):
                        todo.append(cand)
                for i in range(1, len(parts)):
                    init = "/".join(parts[:i] + ["__init__.py"])
                    if os.path.exists(os.path.join(REPO, JAX, init)):
                        todo.append(init)
    missing = sorted(rel for rel in seen if not os.path.exists(os.path.join(REPO, PORT, rel)))
    assert len(seen) > 70 and not missing, missing


def sources(pkg: str, suffixes=(".py", ".cc", ".proto")) -> set[str]:
    root = os.path.join(REPO, pkg)
    return {os.path.relpath(os.path.join(d, n), root) for d, _, files in os.walk(root)
            for n in files if n.endswith(suffixes)}


def test_every_jax_module_has_its_counterpart():
    """Every ``*.py``/``*.cc``/``*.proto`` of the JAX package has a
    counterpart at the same path in the port, but the three device
    modules the port replaces, each by its named replacement. A module
    added to the JAX package fails here until it is ported."""
    jax, port = sources(JAX), sources(PORT)
    missing = sorted(rel for rel in jax - port if rel not in REPLACED)
    assert not missing, missing
    for rel, replacement in REPLACED.items():
        assert rel in jax and rel not in port and replacement in port, rel


@pytest.mark.parametrize("rel", sorted(sources(JAX, (".cc", ".proto")) & sources(PORT)))
def test_schema_and_native_source_is_byte_identical(rel):
    """The ``.proto`` sources keep the JAX package's import paths: the
    descriptors name ``channeld_tpu/...`` files, shared by both packages'
    pb2s. The C++ sources are the JAX package's."""
    assert read(PORT, rel) == read(JAX, rel), rel
