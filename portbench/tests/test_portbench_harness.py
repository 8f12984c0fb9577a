"""The harness: found by name, the contract's shape, each cell at a tiny
size on the CPU, what a run loads, and where it refuses to run."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

import portbench_tiny as tiny
from portbench.core import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = sorted(tiny.SIZES)


def test_each_piece_is_found_by_its_name():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell, config, mix = harness.find_cell(bench, w["name"])
        assert config["name"] == w["config"]
        assert harness.load_driver(config["driver"]).Driver
        assert mix["about"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_benchmark_json_keeps_the_contract():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            assert m["moves"] in [x["name"] for x in harness.metrics_of(bench, w, False)]
    for w in bench["workloads"]:
        got = [m["name"] for m in harness.metrics_of(bench, w["name"], False)]
        assert "setup_s" in got and len(got) >= 2
        assert harness.metrics_of(bench, w["name"], True)
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
        assert json.load(open(harness.ROOT / c["file"]))["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_runs_tiny_on_the_cpu(workload, trace):
    out = tiny.run(workload, seed=2**31 + 7, trace=trace)
    out.pop("_lines")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    bench = harness.benchmark()
    want = {m["name"] for m in harness.metrics_of(bench, workload, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_the_same_seed_gives_the_same_decisions():
    a, b = (tiny.run("crowd.sim100k", seed=11) for _ in range(2))
    assert a["checks"] == b["checks"]


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from portbench.core import harness
import portbench_tiny as tiny
out = tiny.run({workload!r})
assert out["correct"]
print("LOADED", harness.forbidden_modules())
"""


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_and_its_generator_load_nothing_of_jax(workload, tmp_path):
    """A fresh process runs a cell (and, for the sidecar, its generator
    child) and lists the modules whose top-level name, whole, is jax,
    jaxlib, flax or channeld_tpu."""
    here = str(harness.ROOT / "portbench" / "tests")
    code = SCRIPT.format(root=str(harness.ROOT), workload=workload)
    res = subprocess.run([sys.executable, "-c", code], cwd=here, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout
    child = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv=['x']; import portbench.gen.sidecar_child as c; "
         "import portbench.core.harness as h; print(h.forbidden_modules())"],
        cwd=str(harness.ROOT), capture_output=True, text=True, timeout=60)
    assert child.stdout.strip() == "[]", child.stderr


def test_the_port_is_not_jax_by_its_prefix():
    """``channeld_tpu_torch`` starts with the JAX package's name; the check
    compares the top-level name whole."""
    saved = dict(sys.modules)
    try:
        sys.modules["channeld_tpu_torch_probe"] = object()
        assert "channeld_tpu_torch_probe" not in harness.forbidden_modules()
        sys.modules["channeld_tpu.probe"] = object()
        assert "channeld_tpu.probe" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_without_a_card_it_prints_no_result():
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "crowd.sim100k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=str(harness.ROOT), capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "correct" not in res.stdout


def test_with_only_the_benchmark_it_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench")
    code = ("import sys; sys.path.insert(0, '.'); from portbench.core import harness; "
            "import json; print(json.dumps(harness.run('crowd.sim100k', 1, 1, False, "
            "device='cpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "correct" not in res.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "4000000007", "--seconds", "3", "--trace", "1"],
                         cwd=str(harness.ROOT), capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
