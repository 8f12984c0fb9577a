"""The sidecar's unary Step, in process: ``SpatialDecisionServicer.step``.

A step is what the gRPC handler does without the socket: the StepRequest's
bytes parsed by the program's generated class, ``step(request, context)``
with a stub context, the StepResponse serialised. Its latency runs from the
request's bytes in hand to the response's bytes out. The requests come from
a child process (``gen.sidecar_child``) that makes them from the seed ahead
of the consumer; the consumer's wait for the next one is kept apart and
printed (it should read about 0, else the cell measures the generator).

Set-up configures the servicer through its ``configure`` handler (the
engine's warm-up builds the kernels), starts the generator, and runs the
configuration's ``warmup_steps`` steps: step 0's full sync and a respawn
wave among them. Every response is kept; the check decodes each with the
benchmark's own reader and holds it to ``reference.sidecar_ref``.
"""

from __future__ import annotations

import json
import os
import statistics
import struct
import subprocess
import sys
import time

from ..core import wire
from ..core.harness import ROOT
from . import Base


class StubContext:
    """The part of a gRPC servicer context the handlers touch."""

    def invocation_metadata(self):
        return ()

    def peer(self) -> str:
        return "ipv4:127.0.0.1:50000"

    def abort(self, code, details):
        raise RuntimeError(f"aborted: {code}: {details}")


class Driver(Base):
    DEVICE_SPANS = ("engine.spatial_step",)

    def setup(self) -> None:
        from channeld_tpu_torch.ops import service

        from ..core.spans import Spans

        self.spans = Spans()  # off until the harness instruments
        self.pb = service._pb()
        self.ctx = StubContext()
        self.svc = service.SpatialDecisionServicer(device=self.device)
        cfg = self.config
        self.svc.configure(self.pb.ConfigRequest.FromString(wire.config_request(
            cfg["grid"], cfg["entity_capacity"], cfg["query_capacity"], cfg["sub_capacity"])),
            self.ctx)
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        self.child = subprocess.Popen(
            [sys.executable, "-m", "portbench.gen.sidecar_child", str(self.seed),
             json.dumps(cfg), json.dumps(self.mix)],
            cwd=str(ROOT), env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            bufsize=1 << 20)
        try:
            import fcntl

            fcntl.fcntl(self.child.stdout.fileno(), 1031, 1 << 20)  # F_SETPIPE_SZ
        except OSError:
            pass
        self.responses: list[bytes] = []
        self.waits_ms: list[float] = []
        self._live = 0
        for _ in range(int(cfg["warmup_steps"])):
            self.step()
        self.sync()
        self.waits_ms.clear()

    def _frame(self) -> bytes:
        head = self.child.stdout.read(8)
        if len(head) < 8:
            raise RuntimeError("the request generator stopped")
        size, self._live = struct.unpack("<II", head)
        return self.child.stdout.read(size)

    def step(self) -> float:
        spans = self.spans
        t_wait = time.perf_counter()
        with spans.span("sidecar.wait"):
            frame = self._frame()
        t0 = time.perf_counter()
        self.waits_ms.append((t0 - t_wait) * 1e3)
        with spans.span("sidecar.parse"):
            req = self.pb.StepRequest.FromString(frame)
        resp = self.svc.step(req, self.ctx)
        with spans.span("sidecar.serialize"):
            out = resp.SerializeToString()
        lat = time.perf_counter() - t0
        if resp.error:
            self.failed += 1
        self.responses.append(out)
        return lat

    def live(self) -> int:
        return self._live

    def instrument(self, spans) -> None:
        from channeld_tpu_torch.ops import engine as engine_mod

        self.spans = spans
        spans.wrap(self.svc, "step", "sidecar.step")
        spans.wrap(self.svc, "_decide", "sidecar.decide")
        eng = self.svc.engine
        for attr, name in (("tick", "engine.tick"), ("_flush_host_state", "engine.flush"),
                           ("consume", "engine.consume"),
                           ("interest_rows", "engine.interest_rows"),
                           ("handover_list", "engine.handover_list")):
            spans.wrap(eng, attr, name)
        spans.wrap(engine_mod, "spatial_step", "engine.spatial_step", device=True)

    def info(self) -> list[str]:
        w = self.waits_ms
        if not w:
            return []
        return [f"generator wait per step: mean {statistics.fmean(w):.4f} ms, "
                f"max {max(w):.4f} ms over {len(w)} steps"]

    def close(self) -> None:
        child = getattr(self, "child", None)
        if child is not None:
            child.stdout.close()
            try:
                child.wait(timeout=30)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        self.svc = None
        self.free_device()

    def check(self) -> tuple[dict, list[str]]:
        """Every step of the run, warm-up included, against the reference."""
        from ..gen.sidecar_load import Load
        from ..reference.sidecar_ref import SidecarRef, compare

        cfg = self.config
        load = Load(self.seed, cfg["grid"], self.mix)
        ref = SidecarRef(cfg["grid"], cfg["entity_capacity"], cfg["query_capacity"],
                         cfg["sub_capacity"], cfg["max_handovers"])
        wrong, band, first = 0, 0, None
        t0 = time.perf_counter()
        for i, buf in enumerate(self.responses):
            diffs, b = compare(wire.step_response(buf), ref.apply(load.step(i)))
            band += b
            if diffs:
                wrong += 1
                first = first or f"step {i}: {diffs[:4]}"
        lines = [f"reference: {len(self.responses)} steps compared in "
                 f"{time.perf_counter() - t0:.1f} s; cone pairs inside the threshold's "
                 f"band: {band}"]
        if first:
            lines.append(f"first difference: {first}")
        return {"steps_wrong": (wrong, 0)}, lines
