"""Host-clock spans around the calls into each layer of the program.

The benchmark's own spans: ``Spans.wrap`` replaces a function or method with
a wrapper that records (name, parent, start, end) while recording is on, and
leaves the call alone otherwise; ``Spans.span`` does the same for a block of
the benchmark's own drive. A span marked ``device`` also opens a
``torch.profiler.record_function`` range of its name while the profiler
asks for them (``ranges``), so that the device time of the kernels it
launches can be read from the trace. ``restore`` puts every wrapped
attribute back.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple


class Event(NamedTuple):
    name: str
    parent: str  # "" at the top
    t0: float
    t1: float


class Spans:
    def __init__(self):
        self.on = False
        self.ranges = False
        self.events: list[Event] = []
        self._stack: list[str] = []
        self._restore: list = []

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False):
        if not self.on:
            yield
            return
        parent = self._stack[-1] if self._stack else ""
        self._stack.append(name)
        rng = contextlib.nullcontext()
        if device and self.ranges:
            from torch.profiler import record_function

            rng = record_function(name)
        t0 = time.perf_counter()
        try:
            with rng:
                yield
        finally:
            t1 = time.perf_counter()
            self._stack.pop()
            self.events.append(Event(name, parent, t0, t1))

    def wrap(self, owner, attr: str, name: str, device: bool = False) -> None:
        fn = getattr(owner, attr)
        had_own = isinstance(owner, object) and attr in getattr(owner, "__dict__", {})

        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            with self.span(name, device):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._restore.append((owner, attr, fn if had_own else None))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._restore):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._restore.clear()

    def take(self) -> list[Event]:
        out, self.events = self.events, []
        return out

