"""tpulint over the port (``python -m channeld_tpu_torch.analysis``).

The port's suite is clean over ``channeld_tpu_torch`` and
``chip_smoke.py`` with its reasoned baseline; the hot-readback rule
flags torch's implicit syncs seeded into ``GPUSpatialController.tick``
and leaves the engine's batched helpers alone; async-blocking flags
torch's device waits in coroutines; fence-discipline flags a device wait
between the engine's generation fence and its stores; proto-drift is
clean over the port's schemas (compiled under their shared
``channeld_tpu/...`` names) and catches an injected field renumbering.
"""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from channeld_tpu_torch.analysis import (
    BASELINE_FILE,
    Baseline,
    ModuleInfo,
    RepoContext,
    load_repo,
    make_rules,
    pb2io,
    run_analysis,
    threadmodel,
)
from channeld_tpu_torch.analysis.rules.affinity import FenceDisciplineRule
from channeld_tpu_torch.analysis.rules.async_blocking import AsyncBlockingRule
from channeld_tpu_torch.analysis.rules.proto_drift import check_proto_pair
from channeld_tpu_torch.analysis.rules.readback import HotPathReadbackRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_REL = "channeld_tpu_torch/spatial/gpu_controller.py"
ENGINE_REL = "channeld_tpu_torch/ops/engine.py"


def mod(rel: str, text: str) -> ModuleInfo:
    return ModuleInfo(path=rel, rel=rel, text=text, tree=ast.parse(text),
                      lines=text.split("\n"))


def source(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def seeded(rel: str, anchor: str, line: str, after: bool = True) -> ModuleInfo:
    """The module ``rel`` with ``line`` inserted after (or before) the
    first line equal to ``anchor``."""
    lines = source(rel).split("\n")
    i = lines.index(anchor)
    lines.insert(i + 1 if after else i, line)
    return mod(rel, "\n".join(lines))


@pytest.fixture(scope="module")
def report():
    repo = load_repo(REPO)
    return run_analysis(repo, make_rules(), Baseline.load(os.path.join(REPO, BASELINE_FILE)))


def test_port_is_clean_with_a_reasoned_baseline(report):
    assert not report.findings, [f.render() for f in report.findings]
    assert not report.stale_baseline and not report.unreasoned_baseline
    with open(os.path.join(REPO, BASELINE_FILE)) as f:
        entries = json.load(f)["suppressions"]
    assert entries and all(len(e["reason"]) > 40 for e in entries)
    assert all(e["key"].split(":")[1].startswith("channeld_tpu_torch/") for e in entries)
    paths = {f.path for f, _ in report.suppressed}
    assert "chip_smoke.py" not in paths and GPU_REL in paths


def test_cli_exits_zero_over_the_port():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "channeld_tpu_torch.analysis"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert "0 finding(s)" in out.stdout


def test_scan_covers_the_port_and_chip_smoke_only():
    rels = {m.rel for m in load_repo(REPO).modules}
    assert "chip_smoke.py" in rels and GPU_REL in rels
    assert not any(r.startswith(("channeld_tpu/", "scripts/")) for r in rels)


SYNCS = {
    ".item()": "        _probe = self.engine._d_cell.sum().item()",
    ".cpu()": "        _probe = self.engine._d_cell.cpu()",
    ".numpy()": "        _probe = self.engine._d_cell.numpy()",
    ".tolist()": "        _probe = self.engine._d_cell.tolist()",
    ".to('cpu')": "        _probe = self.engine._d_cell.to('cpu')",
    ".synchronize()": "        torch.cuda.synchronize()",
    "int(tensor)": "        _probe = int(self.engine._d_valid.sum())",
}


@pytest.mark.parametrize("detector", sorted(SYNCS))
def test_seeded_sync_in_gpu_controller_tick_is_flagged(detector):
    m = seeded(GPU_REL, "    def tick(self) -> None:", SYNCS[detector])
    found = [(f.scope, f.detector) for f in HotPathReadbackRule().check_module(
        m, RepoContext(root=REPO, modules=[m]))]
    assert found == [("GPUSpatialController._publish_due", ".tolist()"),
                     ("GPUSpatialController.tick", detector)], found


def test_unseeded_gpu_controller_flags_only_its_baselined_host_read():
    m = mod(GPU_REL, source(GPU_REL))
    found = [(f.scope, f.detector) for f in HotPathReadbackRule().check_module(
        m, RepoContext(root=REPO, modules=[m]))]
    assert found == [("GPUSpatialController._publish_due", ".tolist()")]


def test_batched_engine_helpers_are_not_flagged():
    """The engine owns its transfers (consume, query_changed_rows,
    handover_list, interested_cells_batch read the device by design):
    ops/engine.py is out of the rule's scope, and a tick path calling
    the batched helpers is clean."""
    eng = mod(ENGINE_REL, source(ENGINE_REL))
    assert ".cpu()" in eng.text or ".numpy()" in eng.text
    assert HotPathReadbackRule().check_module(eng, RepoContext(root=REPO, modules=[eng])) == []
    m = mod(GPU_REL, (
        "class GPUSpatialController:\n"
        "    def tick(self):\n"
        "        result = self.engine.last_result\n"
        "        count, rows, _, due = self.engine.consume(result)\n"
        "        q = self.engine.query_changed_rows(result)\n"
        "        crossings = self.engine.handover_list(result)\n"
        "    def _apply_follow_interests(self, result, live):\n"
        "        cells = self.engine.interested_cells_batch(result, live)\n"
    ))
    assert HotPathReadbackRule().check_module(m, RepoContext(root=REPO, modules=[m])) == []


@pytest.mark.parametrize("call", ["torch.cuda.synchronize()", "done.synchronize()",
                                  "torch.cuda.current_stream().synchronize()"])
def test_async_blocking_flags_a_device_wait_in_a_coroutine(call):
    m = mod("channeld_tpu_torch/federation/trunk.py", (
        "import torch\n"
        "async def pump(done):\n"
        f"    {call}\n"
    ))
    found = {f.detector for f in AsyncBlockingRule().check_module(
        m, RepoContext(root=REPO, modules=[m]))}
    assert found & {"torch.cuda.synchronize", "synchronize"}, found


def test_fence_discipline_flags_a_device_wait_between_fence_and_store():
    repo = load_repo(REPO)
    clean = repo.module(ENGINE_REL)
    assert FenceDisciplineRule().check_module(clean, repo) == []
    m = seeded(ENGINE_REL, '        self._d_cell = out["committed_prev"]',
               "        torch.cuda.synchronize()", after=False)
    repo.modules = [m if x.rel == ENGINE_REL else x for x in repo.modules]
    found = {f.detector for f in FenceDisciplineRule().check_module(m, repo)}
    assert "unfenced-store:_d_cell" in found


def test_thread_model_places_the_gpu_controller_tick_on_the_loop():
    model = threadmodel.build_model(load_repo(REPO))
    assert not model.stale_seeds
    assert "tick-loop" in model.domains_of(GPU_REL, "GPUSpatialController.tick")
    assert "device-worker" in model.domains_of(ENGINE_REL, "SpatialEngine.tick")


def port_protos() -> list[str]:
    return sorted(glob.glob(os.path.join(REPO, "channeld_tpu_torch/protocol/*.proto")))


@pytest.mark.parametrize("proto", [os.path.basename(p) for p in port_protos()])
def test_proto_drift_port_schema_is_clean(proto):
    path = os.path.join(REPO, "channeld_tpu_torch/protocol", proto)
    assert check_proto_pair(path, path[:-len(".proto")] + "_pb2.py", REPO) == []


def test_proto_drift_catches_an_injected_field_renumbering(tmp_path):
    """Renumber one field of the port's wire_pb2 (the classic hand-regen
    mistake) in a copy of the port's schemas: exactly that field drifts."""
    dst = tmp_path / "channeld_tpu_torch" / "protocol"
    shutil.copytree(os.path.join(REPO, "channeld_tpu_torch/protocol"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb2 = dst / "wire_pb2.py"
    fdp = pb2io.parse_pb2_descriptor(pb2.read_text(), "channeld_tpu_torch/protocol/wire_pb2.py")
    msg = next(m for m in fdp.message_type if m.name == "MessagePack")
    field = msg.field[1]
    name, number = field.name, field.number
    field.number = 15
    pb2.write_text(pb2io.emit_pb2_module(fdp, "channeld_tpu_torch.protocol.wire_pb2"))
    findings = check_proto_pair(str(dst / "wire.proto"), str(pb2), str(tmp_path))
    assert len(findings) == 1, [f.render() for f in findings]
    assert name in findings[0].message
    assert "= 15" in findings[0].message and f"= {number}" in findings[0].message
