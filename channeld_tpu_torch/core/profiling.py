"""Profiling hooks (ref: pkg/channeld/profiling.go:12-31).

``-profile cpu`` -> cProfile, ``-profile mem`` -> tracemalloc,
``-profile gpu`` -> a torch.profiler trace (host ops and, on a CUDA
card, kernels and copies; a Chrome trace viewable in Perfetto, written
under ``gpu_trace`` on stop), ``-profile tasks`` -> the
asyncio analog of the reference's "goroutine" mode: a dump of every
live task (the per-channel tick tasks, listeners, pumps) with its
current stack, plus every OS thread's stack. Results are written to the
profile path on shutdown, with a signal-safe stop on SIGINT/SIGTERM
like the reference's pkg/profile integration; ``dump_tasks()`` can also
be called at any point for a live snapshot.
"""

from __future__ import annotations

import atexit
import os
import signal
import time
from typing import Optional

from ..utils.logger import get_logger

logger = get_logger("profiling")

_cpu_profiler = None
_mem_tracing = False
_gpu_profiler = None
_gpu_trace_dir: Optional[str] = None
_tasks_mode = False
_profile_path = "profiles"


def dump_tasks(out=None) -> str:
    """Write every asyncio task's current stack + every thread's stack —
    the honest analog of the reference's `-profile=goroutine` dump
    (profiling.go:12-31): the runtime's unit of concurrency is the task
    (one per channel tick, listener, pump), so this is what "where is
    everything stuck" means here. Returns the formatted dump."""
    import asyncio
    import io
    import sys
    import traceback

    buf = io.StringIO()
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    tasks = asyncio.all_tasks(loop) if loop is not None else set()
    buf.write(f"=== asyncio tasks: {len(tasks)} ===\n")
    for task in sorted(tasks, key=lambda t: t.get_name()):
        coro = task.get_coro()
        state = "cancelled" if task.cancelled() else (
            "done" if task.done() else "running")
        buf.write(f"\n--- task {task.get_name()} [{state}] "
                  f"{getattr(coro, '__qualname__', coro)!r}\n")
        for line in task.get_stack(limit=12):
            buf.write("".join(traceback.format_stack(line, limit=1)))
    buf.write(f"\n=== threads: {len(sys._current_frames())} ===\n")
    for tid, frame in sys._current_frames().items():
        buf.write(f"\n--- thread {tid}\n")
        buf.write("".join(traceback.format_stack(frame, limit=12)))
    text = buf.getvalue()
    if out is not None:
        out.write(text)
    return text


def install_task_dump_signal(profile_path: str = "profiles") -> bool:
    """Bind SIGUSR1 to a live task/thread dump so a stuck gateway can be
    diagnosed WITHOUT ``-profile tasks`` having been pre-armed:
    ``kill -USR1 <pid>`` writes the dump under the profile path and logs
    where. Installed at server start (run_server); False where SIGUSR1
    does not exist (non-POSIX) or outside the main thread."""

    def _on_sigusr1(signum, frame) -> None:
        os.makedirs(profile_path, exist_ok=True)
        path = os.path.join(
            profile_path,
            f"tasks_sigusr1_{time.strftime('%Y%m%d%H%M%S')}.txt",
        )
        with open(path, "w") as f:
            dump_tasks(f)
        logger.warning("SIGUSR1: live task/thread dump written to %s", path)

    sig = getattr(signal, "SIGUSR1", None)
    if sig is None:
        return False
    try:
        signal.signal(sig, _on_sigusr1)
    except ValueError:
        return False  # not the main thread
    return True


def start_profiling(kind: str, profile_path: str = "profiles") -> None:
    """(ref: StartProfiling). kind in {"", "cpu", "mem", "gpu", "tasks"}."""
    global _cpu_profiler, _mem_tracing, _gpu_profiler, _gpu_trace_dir, \
        _tasks_mode, _profile_path
    if not kind:
        return
    _profile_path = profile_path
    os.makedirs(profile_path, exist_ok=True)
    if kind == "cpu":
        import cProfile

        _cpu_profiler = cProfile.Profile()
        _cpu_profiler.enable()
        logger.info("CPU profiling started")
    elif kind == "mem":
        import tracemalloc

        tracemalloc.start()
        _mem_tracing = True
        logger.info("memory profiling started")
    elif kind == "gpu":
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        _gpu_trace_dir = os.path.join(profile_path, "gpu_trace")
        _gpu_profiler = torch.profiler.profile(activities=activities)
        _gpu_profiler.start()
        logger.info("device trace started -> %s", _gpu_trace_dir)
    elif kind == "tasks":
        _tasks_mode = True
        logger.info("task-dump profiling armed (dump written on stop)")
    else:
        raise ValueError(f"invalid profile type: {kind}")

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _stop_and_exit)
        except ValueError:
            pass  # not the main thread
    atexit.register(stop_profiling)


def stop_profiling() -> Optional[str]:
    global _cpu_profiler, _mem_tracing, _gpu_profiler, _gpu_trace_dir, \
        _tasks_mode
    stamp = time.strftime("%Y%m%d%H%M%S")
    if _tasks_mode:
        _tasks_mode = False
        path = os.path.join(_profile_path, f"tasks_{stamp}.txt")
        with open(path, "w") as f:
            dump_tasks(f)
        logger.info("task dump written to %s", path)
        return path
    if _gpu_profiler is not None:
        _gpu_profiler.stop()
        os.makedirs(_gpu_trace_dir, exist_ok=True)
        path = os.path.join(_gpu_trace_dir, f"trace_{stamp}.json")
        _gpu_profiler.export_chrome_trace(path)
        _gpu_profiler, _gpu_trace_dir = None, None
        logger.info("device trace written to %s", path)
        return path
    if _cpu_profiler is not None:
        path = os.path.join(_profile_path, f"cpu_{stamp}.pstats")
        _cpu_profiler.disable()
        _cpu_profiler.dump_stats(path)
        _cpu_profiler = None
        logger.info("CPU profile written to %s", path)
        return path
    if _mem_tracing:
        import tracemalloc

        path = os.path.join(_profile_path, f"mem_{stamp}.txt")
        snapshot = tracemalloc.take_snapshot()
        with open(path, "w") as f:
            for stat in snapshot.statistics("lineno")[:100]:
                f.write(f"{stat}\n")
        tracemalloc.stop()
        _mem_tracing = False
        logger.info("memory profile written to %s", path)
        return path
    return None


def _stop_and_exit(signum, frame) -> None:
    # Flush the profile, then re-deliver the signal with default semantics
    # so exit codes (130/143) and KeyboardInterrupt behavior are preserved.
    stop_profiling()
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)
