"""Device time: the profiler's readings, kernel bounds, host reads.

Frozen copies, each from ``chip_smoke.py`` of the tree this benchmark was
written against, imported from nowhere else:

- ``bound_ms`` (line 659) and the peaks beside it (lines 522-530): NVIDIA's
  published H100 SXM peaks, bytes / 3.35 TB/s against float ops /
  67 TFLOP/s;
- ``Reads`` (line 1145): reads of CUDA tensors into host memory and the
  host's waits for the card, from PyTorch's sync-debug mode;
- the busy arithmetic of ``device_rows`` (line 1093): device-side events
  only (kernels, copies, fills), so that no kernel is counted twice through
  the CPU-side operator that launched it.

``DeviceWindow`` differs from the original ``profile_window`` in its base:
it records device activity only and takes the wall of the window from an
anchor kernel launched on an idle device, so the profiler's CPU-side
recording does not pad the wall the idle share divides by.
"""

from __future__ import annotations

import time
import warnings

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
# Float operations the AOI function needs per (query, cell) pair once its
# per-axis terms are formed (two sums, a root, the scaling, a ceiling and
# the tests), and per (query, column) or (query, row) (centre, delta, gap,
# three products, the box test).
AOI_OPS_PER_PAIR = 8
AOI_OPS_PER_AXIS = 12
ASSIGN_OPS_PER_SLOT = 10  # 2 sub, 2 mul, 2 floor, 4 compares


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def assign_count_bound_ms(slots: int, cells: int) -> tuple[float, str]:
    """K1: positions f32[N,3] and valid bool[N] read once; cell i32[N] and
    counts i32[C] written once."""
    return bound_ms(slots * (12 + 1 + 4) + cells * 4, ASSIGN_OPS_PER_SLOT * slots)


def aoi_bound_ms(queries: int, cols: int, rows: int) -> tuple[float, str]:
    """K2 over the whole grid: kind, centre, extent, direction and the cone
    threshold read once per query; hit bool[Q,C] and dist i32[Q,C] written
    once."""
    cells = cols * rows
    return bound_ms(queries * (4 + 3 * 8 + 4) + queries * cells * 5,
                    AOI_OPS_PER_PAIR * queries * cells + AOI_OPS_PER_AXIS * queries * (cols + rows))


class Reads:
    """Counts reads of CUDA tensors into host memory while entered (``cpu``,
    ``numpy``, ``item``, ``tolist`` and the bool/int/float/index
    conversions), and every point where the host waited for the card
    (``syncs``, from PyTorch's sync debug mode, which also sees waits
    inside library ops and host-to-device copies)."""

    NAMES = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self):
        self.count = 0
        self.syncs = 0

    def __enter__(self):
        import torch

        self._torch = torch
        self._saved = {n: torch.Tensor.__dict__.get(n) for n in self.NAMES}
        for name in self.NAMES:
            fn = getattr(torch.Tensor, name)

            def counted(t, *args, _fn=fn, **kwargs):
                if t.is_cuda:
                    self.count += 1
                return _fn(t, *args, **kwargs)

            setattr(torch.Tensor, name, counted)
        self._caught = warnings.catch_warnings(record=True)
        self._log = self._caught.__enter__()
        warnings.simplefilter("always")
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch = self._torch
        torch.cuda.set_sync_debug_mode(self._mode)
        self.syncs = sum("synchroniz" in str(w.message) for w in self._log)
        self._caught.__exit__(*exc)
        for name, fn in self._saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        return False


def _device_events(prof) -> list:
    """[(name, start_us, end_us)] of the trace's device-side events,
    sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    out.sort(key=lambda r: r[1])
    return out


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class DeviceWindow:
    """The device's activity over a stretch of steps, from a torch.profiler
    trace that records device activity only.

    Entering synchronises, notes the host clock and launches a short anchor
    kernel on the idle device; the first device event of the trace is that
    kernel, which ties the trace's clock to the host's (within a launch's
    latency). ``events`` are the device events with host-clock times;
    ``busy_s`` is the union of their intervals, ``window_s`` the host
    clock from the anchor to the synchronise at exit."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1000)
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        raw = _device_events(self._prof)
        self.events = []
        if raw:
            base = raw[0][1]
            self.events = [(n, self.t0 + (s - base) / 1e6, self.t0 + (e - base) / 1e6)
                           for n, s, e in raw]
        self.window_s = self.t1 - self.t0
        busy = union([(s, e) for _, s, e in self.events])
        self.busy = busy
        self.busy_s = sum(e - s for s, e in busy)
        return False

    def kernel_ms(self, name_part: str) -> list:
        return [(e - s) * 1e3 for n, s, e in self.events if name_part in n]

    def by_name(self) -> list:
        """[(name, seconds)] of device time by event name, largest first."""
        tot: dict[str, float] = {}
        for n, s, e in self.events:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> list:
        """[(start, end)] host-clock gaps in which the device ran nothing,
        inside the window."""
        gaps, at = [], self.t0
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps


def span_device_ms(prof, name: str, annotations: set) -> tuple[float, int]:
    """(device ms, ranges) of the kernels run inside every
    ``record_function(name)`` range of a CPU+CUDA trace: the device-side
    ranges the profiler draws for the annotation, intersected with the
    union of the device events that are not themselves such ranges (names
    in ``annotations``), so no event counts twice. Falls back on the
    CPU-side range's ``device_time_total`` where the trace draws no
    device-side range."""
    from torch.autograd import DeviceType

    ranges, device, cpu_total, cpu_n = [], [], 0.0, 0
    for e in prof.events():
        if e.name == name:
            if e.device_type == DeviceType.CUDA:
                ranges.append((float(e.time_range.start), float(e.time_range.end)))
            else:
                cpu_total += float(e.device_time_total)
                cpu_n += 1
        elif e.device_type == DeviceType.CUDA and e.name not in annotations:
            device.append((float(e.time_range.start), float(e.time_range.end)))
    if not ranges:
        return cpu_total / 1e3, cpu_n
    busy = union(device)
    total = 0.0
    for a, b in ranges:
        for s, e in busy:
            lo, hi = max(a, s), min(b, e)
            if hi > lo:
                total += hi - lo
    return total / 1e3, len(ranges)
