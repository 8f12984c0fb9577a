"""One run of one cell: set-up, the measured window, the check, the result.

``main`` is what ``portbench/run.py`` calls. It finds the cell in
BENCHMARK.json, its configuration in ``configs/<config>.json``, its mix in
``traffic/<mix>.json``, the entry driver that the configuration names in
``drivers/<driver>.py`` and each metric's reader in ``metrics/<metric>.py``,
so a later cell, mix, driver or metric is a new file and a new entry.

A run: the entry driver builds the program and warms up every shape its traffic
uses (``setup_s``, from the start of the process's harness to the end of the
warm-up); then steps in a closed loop for ``--seconds`` (a decision is
driven only once the last one is in hand); then the window closes, the
device's peak memory is read, the entry driver frees the program and compares
what the window produced with its plain reference.

With ``--trace 1`` the same window also carries the benchmark's spans around
the calls into each layer, and in its middle three stretches of steady steps:
``reads_steps`` steps counted by ``Reads``, ``profile_steps`` steps under a
device-only profiler (busy share, kernels, idle gaps) and ``profile_steps``
steps under a CPU+CUDA profiler with a range per device span (the device time
inside the spans). The spans' metrics read only the steps outside those
stretches.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "channeld_tpu")
READS_STEPS = 5
PROFILE_STEPS = 20
NAME_CHARS = 120  # of a kernel's name in the breakdown (its templates run on)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, name: str):
    """(cell, configuration, mix) of the workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, mix


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced."""
    if not trace:
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in metrics_of(bench, cell, False)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


class Window:
    """What the measured window saw, step by step."""

    def __init__(self):
        self.latency_ms: list[float] = []
        self.live: list[int] = []
        self.steps_a: list[dict] = []  # steps outside the trace's stretches
        self.seconds = 0.0
        self.cpu_s = 0.0
        self.done_at: list[float] = []  # seconds into the window


def _phase(trace: bool, device_ok: bool, elapsed: float, seconds: float, done: dict) -> str:
    """Which stretch of a traced window the next step belongs to."""
    if not trace or not device_ok or elapsed < 0.5 * seconds:
        return "a"
    for name, n in (("reads", READS_STEPS), ("device", PROFILE_STEPS),
                    ("ranges", PROFILE_STEPS)):
        if done.get(name, 0) < n:
            return name
    return "a"


def run_window(driver, spans, seconds: float, trace: bool, device) -> tuple[Window, dict]:
    """Step the entry driver for ``seconds``; with ``trace``, also the three
    stretches (see the module's docstring). Returns the window and the
    trace's readings."""
    import torch

    from . import devtime

    w = Window()
    cpu0 = time.process_time()
    done: dict[str, int] = {}
    readings: dict = {}
    device_ok = torch.device(device).type == "cuda"
    spans.on = trace
    stretch = None  # (name, context manager) while one is open
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        phase = _phase(trace, device_ok, elapsed, seconds, done)
        if phase == "a" and elapsed >= seconds and stretch is None and w.latency_ms:
            break
        if stretch is not None and stretch[0] != phase:
            stretch[1].__exit__(None, None, None)
            readings[stretch[0]] = (stretch[1], done[stretch[0]], spans.take())
            stretch = None
        if phase != "a" and stretch is None:
            spans.take()
            if phase == "reads":
                ctx = devtime.Reads()
            elif phase == "device":
                ctx = devtime.DeviceWindow()
            else:
                spans.ranges = True
                from torch.profiler import ProfilerActivity, profile

                ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            ctx.__enter__()
            stretch = (phase, ctx)
        lat = driver.step()
        w.done_at.append(time.perf_counter() - t0)
        w.latency_ms.append(lat * 1e3)
        w.live.append(driver.live())
        if phase == "a":
            if trace:
                w.steps_a.append(dict(lat_ms=lat * 1e3, events=spans.take()))
        else:
            done[phase] = done.get(phase, 0) + 1
            if phase == "ranges" and done[phase] == PROFILE_STEPS:
                spans.ranges = False
    driver.sync()
    w.seconds = time.perf_counter() - t0
    w.cpu_s = time.process_time() - cpu0
    spans.on = False
    return w, readings


def window_line(w: Window) -> str:
    """The window's latencies and the host's CPU time, for the log."""
    import numpy as np

    q = np.percentile(w.latency_ms, [10, 50, 90, 99, 100])
    per5 = np.bincount((np.asarray(w.done_at) // 5).astype(int)).tolist()
    return (f"window: {len(w.latency_ms)} decisions in {w.seconds:.3f} s; latency ms p10 "
            f"{q[0]:.3f} p50 {q[1]:.3f} p90 {q[2]:.3f} p99 {q[3]:.3f} max {q[4]:.3f}; "
            f"decisions per 5 s {per5}; host CPU {w.cpu_s:.3f} s of it")


def trace_record(w: Window, readings: dict, driver) -> dict:
    """The traced run's record, which the per-layer metrics read."""
    from . import devtime

    rec = dict(steps_a=w.steps_a, shapes=driver.kernel_shapes())
    if "reads" in readings:
        reads, n, _ = readings["reads"]
        rec["reads"] = dict(steps=n, syncs=reads.syncs, count=reads.count)
    if "device" in readings:
        dw, n, events = readings["device"]
        rec["device"] = dict(
            steps=n, busy_s=dw.busy_s, window_s=dw.window_s,
            kernel_ms={k: dw.kernel_ms(part) for k, part in driver.KERNELS.items()},
            by_name=dw.by_name(), gaps=_gap_owners(dw.idle_gaps(), events))
    if "ranges" in readings:
        prof, n, _ = readings["ranges"]
        names = set(driver.DEVICE_SPANS)
        rec["span_device"] = {name: devtime.span_device_ms(prof, name, names)
                              for name in names}
        rec["span_device_steps"] = n
    return rec


def _gap_owners(gaps, events) -> list:
    """[(span name, idle seconds)] of the device's idle gaps, each gap (or
    part of one) charged to the innermost span the host was in, largest
    first."""
    spans = sorted(events, key=lambda e: e.t0)
    tot: dict[str, float] = {}
    for a, b in gaps:
        cuts = sorted({a, b, *(t for e in spans for t in (e.t0, e.t1) if a < t < b)})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            inside = [e for e in spans if e.t0 <= mid < e.t1]
            name = min(inside, key=lambda e: e.t1 - e.t0).name if inside else "host.outside_spans"
            tot[name] = tot.get(name, 0.0) + (hi - lo)
    return sorted(tot.items(), key=lambda kv: -kv[1])


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None, bench: dict | None = None, overrides=None) -> dict:
    """One run; returns the result's fields (and ``checks``). ``overrides``
    (tests only) replaces keys of the configuration and the mix."""
    from .spans import Spans

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    cell, config, mix = find_cell(bench, workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    driver = load_driver(config["driver"]).Driver(config, mix, seed, device)
    spans = Spans()
    try:
        driver.setup()
        driver.sync()
        setup_s = time.perf_counter() - t_start
        if trace:
            driver.instrument(spans)
        w, readings = run_window(driver, spans, seconds, trace, device)
        spans.restore()
        peak = driver.memory_peak_bytes()
        info = [window_line(w)] + driver.info()
        rec = trace_record(w, readings, driver) if trace else {}
    finally:
        spans.restore()
        driver.close()
    checks, lines = driver.check()
    rec.update(setup_s=setup_s, window_s=w.seconds, latency_ms=w.latency_ms, live=w.live,
               cell=cell, config=config, mix=mix)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = load_metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if torch_device_type(device) == "cuda" else "cpu",
               kind=driver.device_name(), count=1, memory_peak_bytes=peak)
    out = dict(correct=all(v <= lim for v, lim in checks.values()),
               attempted=len(w.latency_ms), failed=driver.failed, metrics=metrics, device=dev)
    if trace and "device" in rec:
        dev["busy_s"] = rec["device"]["busy_s"]
        dev["window_s"] = rec["device"]["window_s"]
        out["breakdown"] = dict(
            device_ops=[[n[:NAME_CHARS], s] for n, s in rec["device"]["by_name"][:10]],
            idle_gaps=[[n, s] for n, s in rec["device"]["gaps"][:10]])
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    out["_lines"] = info + lines
    return out


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    bench = benchmark()
    cell, _, _ = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: needs {cell['chips']} CUDA device(s); "
              f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
              t_start=t_start, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for line in out.pop("_lines"):
        print(line)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
