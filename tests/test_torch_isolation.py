"""The port stands alone and never falls back to the CPU on its own.

A fresh interpreter imports every module of ``channeld_tpu_torch`` (and
``chip_smoke``) and runs the gateway's ``-h``; afterwards neither
``jax`` nor any ``channeld_tpu`` module may be loaded. Without a CUDA
device, the entry points (the engine, the sidecar, the gateway's spatial
controller) raise unless they are given the CPU; with one, they land on
it. The gateway's host layers import as the reference's do: without the
device library (ROADMAP F26); so do the spatial package, the device guard,
the device pick and the modules that import them, a gateway on the host
grid and ``-h`` (F27), while the GPU controller still loads torch.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import channeld_tpu_torch
names = [m.name for m in pkgutil.walk_packages(channeld_tpu_torch.__path__,
                                               "channeld_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "channeld_tpu" or m.startswith("channeld_tpu."))
assert not leaked, leaked
assert "channeld_tpu_torch.ops.cuda_kernels" in names, names
assert "channeld_tpu_torch.ops.service" in names, names
for name in ("compat", "compat.unreal", "compat.unrealpb_pb2", "models.engine_adapter",
             "replay.harness", "replay.__main__", "native", "analysis", "analysis.__main__",
             "analysis.threadmodel", "analysis.rules.readback", "analysis.rules.proto_drift"):
    assert f"channeld_tpu_torch.{name}" in names, name

import torch
from channeld_tpu_torch.ops import cuda_kernels
from channeld_tpu_torch.ops.engine import SpatialEngine
from channeld_tpu_torch.ops.service import SpatialDecisionServicer, create_server
from channeld_tpu_torch.ops.spatial_ops import GridSpec
from channeld_tpu_torch.utils.devices import resolve_device

assert not cuda_kernels._libs  # importing built nothing
grid = GridSpec(0.0, 0.0, 1.0, 1.0, 2, 2)
entry_points = {
    "resolve_device": lambda: resolve_device(),
    "SpatialEngine": lambda: SpatialEngine(grid, 8, 2, 2).device,
    "SpatialDecisionServicer": lambda: SpatialDecisionServicer().device,
    "create_server": lambda: create_server(port=0)[1].device,
}
for name, call in entry_points.items():
    if torch.cuda.is_available():
        assert call().type == "cuda", name
    else:
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), (name, e)
        else:
            raise AssertionError(f"{name} ran without CUDA and without device='cpu'")
assert SpatialEngine(grid, 8, 2, 2, device="cpu").device.type == "cpu"

# The gateway's controller, as the configs select it.
from channeld_tpu_torch.core import channel
from channeld_tpu_torch.core.message import init_message_map
from channeld_tpu_torch.core.settings import global_settings
from channeld_tpu_torch.spatial import controller

init_message_map()
channel.init_channels()


def init_controller():
    controller.init_spatial_controller("config/spatial_tpu_4x4.json")
    ctl = controller.get_spatial_controller()
    assert type(ctl).__name__ == "GPUSpatialController", type(ctl)
    return ctl.engine.device


if torch.cuda.is_available():
    assert init_controller().type == "cuda"
else:
    try:
        init_controller()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("the controller ran without CUDA and without -spatial-device cpu")
global_settings.spatial_device = "cpu"
assert init_controller().type == "cpu"

# The gateway's entry point, as `python -m channeld_tpu_torch -h` runs it.
import runpy

sys.argv = ["channeld_tpu_torch", "-h"]
try:
    runpy.run_module("channeld_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), e.code
else:
    raise AssertionError("-h did not exit")
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "channeld_tpu" or m.startswith("channeld_tpu."))
assert not leaked, leaked
print("ISOLATED", len(names))
"""


def test_port_imports_nothing_of_jax_and_does_not_fall_back():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout


def test_gateway_entry_point_help_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "channeld_tpu_torch", "-h"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "-spatial-device" in out.stdout


HOST_PROBE = r"""
import sys
import channeld_tpu_torch.core.server
loaded = sorted(m for m in sys.modules
                if m in ("torch", "jax", "channeld_tpu")
                or m.startswith(("torch.", "jax.", "channeld_tpu.")))
assert not loaded, loaded
print("HOST ONLY")
"""


def test_the_gateway_host_layers_import_without_torch():
    """``import channeld_tpu_torch.core.server`` in a fresh interpreter
    leaves ``torch``, ``jax`` and ``channeld_tpu`` unloaded, as
    ``import channeld_tpu.core.server`` leaves ``jax`` (F26: the ``utils``
    package re-exported a torch module)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", HOST_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "HOST ONLY" in out.stdout


# The port's modules whose counterparts load no JAX, which loaded torch at
# import until F27 was repaired: the spatial package (through
# gpu_controller's import of core.device_guard), the modules that import it,
# core.device_guard and utils.devices. Each pair: (port module, JAX module).
F27_MODULES = [(f"spatial{m}", f"spatial{m}") for m in (
    "", ".balancer", ".celltree", ".controller", ".entity", ".grid", ".messages",
    ".partition")] + [
    ("spatial.gpu_controller", "spatial.tpu_controller"), ("core.device_guard",) * 2,
    ("models.sim",) * 2, ("models.engine_adapter",) * 2, ("compat.unreal",) * 2,
    ("utils.devices",) * 2]

F27_PROBE = r"""
import importlib, runpy, sys
for name in {names!r}:
    importlib.import_module(name)
{extra}
loaded = sorted(m for m in sys.modules if m == {lib!r} or m.startswith({lib!r} + "."))
assert not loaded, loaded[:5]
print("NO", {lib!r})
"""

HOST_GRID_AND_HELP = r"""
from channeld_tpu_torch.core import channel
from channeld_tpu_torch.core.message import init_message_map
from channeld_tpu_torch.spatial import controller

init_message_map()
channel.init_channels()
controller.init_spatial_controller("config/spatial_static_2x2.json")
assert type(controller.get_spatial_controller()).__name__ == "StaticGrid2DSpatialController"
sys.argv = ["channeld_tpu_torch", "-h"]
try:
    runpy.run_module("channeld_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), e.code
"""


def run_probe(code: str, marker: str) -> None:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert marker in out.stdout


def test_host_modules_host_grid_and_help_load_no_torch():
    """F27: in a fresh interpreter, the port modules of ``F27_MODULES``, a
    gateway's host-grid controller (config/spatial_static_2x2.json) and
    ``python -m channeld_tpu_torch -h`` leave torch unloaded, as their JAX
    counterparts leave JAX."""
    run_probe(F27_PROBE.format(names=[f"channeld_tpu_torch.{p}" for p, _ in F27_MODULES],
                               extra=HOST_GRID_AND_HELP, lib="torch"), "NO torch")


def test_the_jax_counterparts_load_no_jax():
    """The list above is honest: each JAX counterpart loads no JAX."""
    run_probe(F27_PROBE.format(names=[f"channeld_tpu.{j}" for _, j in F27_MODULES], extra="",
                               lib="jax"), "NO jax")


DEVICE_GRID_PROBE = r"""
import sys
from channeld_tpu_torch.core import channel
from channeld_tpu_torch.core.message import init_message_map
from channeld_tpu_torch.core.settings import global_settings
from channeld_tpu_torch.spatial import controller

init_message_map()
channel.init_channels()
assert "torch" not in sys.modules
global_settings.spatial_device = "cpu"
controller.init_spatial_controller("config/spatial_tpu_4x4.json")
ctl = controller.get_spatial_controller()
assert type(ctl).__name__ == "GPUSpatialController", type(ctl)
assert ctl.engine.device.type == "cpu" and "torch" in sys.modules
print("DEVICE GRID")
"""


def test_the_device_controller_loads_torch():
    """The GPU controller (config/spatial_tpu_4x4.json) still loads torch,
    at its config's load, and builds its engine where it is told."""
    run_probe(DEVICE_GRID_PROBE, "DEVICE GRID")


GRAFT_ENTRY_PROBE = r"""
import sys
import channeld_tpu_torch.graft_entry as g
assert g.dryrun_multichip(2, device="cpu")["cells_plane"]["overflow"] == 0
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "channeld_tpu" or m.startswith("channeld_tpu."))
assert not leaked, leaked
print("GRAFT ENTRY")
"""


def test_the_graft_entry_loads_no_jax():
    """``channeld_tpu_torch.graft_entry`` (the port's ``__graft_entry__.py``)
    imports and runs its dry run on the CPU without loading ``jax`` or any
    ``channeld_tpu`` module."""
    run_probe(GRAFT_ENTRY_PROBE, "GRAFT ENTRY")
