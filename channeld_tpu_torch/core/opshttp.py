"""Live ops surface: /metrics, /healthz, /readyz, /introspect, /fleet.

The reference serves bare Prometheus exposition from a hardcoded port
(ref: cmd/main.go:50, pkg/channeld/metrics.go); production operation
needs more than a scrape target — k8s probes that tell a live gateway
from a wedged one, a JSON census an operator (or ``scripts/
fleetctl.py``) can read without a Prometheus stack, and the federated
``/fleet`` view (federation/obs.py) that shows the whole fleet from
any one gateway. One small threaded HTTP server carries all of it on
the existing ``-mport`` port:

- ``/metrics`` — the ordinary Prometheus exposition (unchanged
  families; the reference dashboard keeps working).
- ``/healthz`` — liveness: 200 whenever the process can answer HTTP.
  Deliberately lenient — liveness kills should mean "the process is
  gone or wedged beyond HTTP", not "the gateway is busy" (k8s restarts
  on sustained failure; readiness handles the softer states).
- ``/readyz`` — readiness matrix, 200 only when every component
  passes: the local shard is fully allocated (spatial worlds), the
  device guard is not FAILED (doc/device_recovery.md), the WAL writer
  is alive when the journal is armed (doc/persistence.md), and the
  trunk quorum holds when federation is armed (at least half the
  configured peers linked). 503 carries the failing components as
  JSON so the probe log says WHY.
- ``/introspect`` — JSON census: channels, connections, entities,
  overload level, SLO status (core/slo.py), device/WAL/trunk state,
  shard map version.
- ``/fleet`` — the federated aggregate (``fleet_*`` families, one
  scrape shows every gateway; ``?format=json`` for the census form).

The handler threads only take snapshot reads (lens and attribute
loads) of loop-owned state — every component read is individually
guarded, so a half-initialized gateway answers with what it has
instead of a stack trace. See doc/observability.md.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils.logger import get_logger
from .affinity import affinity as _affinity

logger = get_logger("opshttp")

_started_at = time.monotonic()


# ---------------------------------------------------------------------------
# component probes (shared by /readyz, /introspect and the tests)
# ---------------------------------------------------------------------------


def _shard_ready() -> tuple[bool, str]:
    """A spatial world is ready when every server slot this gateway is
    allowed to host is filled by a live connection; a non-spatial
    gateway is ready once the channel plane is up."""
    from ..spatial.controller import get_spatial_controller
    from .channel import get_global_channel

    if get_global_channel() is None:
        return False, "channel plane not initialized"
    ctl = get_spatial_controller()
    if ctl is None:
        return True, "no spatial controller"
    # Grid controllers (spatial/grid.py — both shipped controller
    # classes) expose server slots; an alternative controller without
    # them deliberately reads READY (lenient default: an unknown
    # topology must not wedge a gateway unready forever — it should
    # grow its own probe instead).
    allowed = getattr(ctl, "_allowed_server_indices", None)
    slots = getattr(ctl, "server_connections", None)
    if allowed is None or slots is None:
        return True, "controller has no server slots"
    missing = [
        i for i in allowed()
        if i >= len(slots) or slots[i] is None or slots[i].is_closing()
    ]
    if missing:
        return False, f"server slots unfilled: {missing}"
    return True, f"{len(list(allowed()))} server slots filled"


def _device_ready() -> tuple[bool, str]:
    from .device_guard import DeviceState, guard
    from .settings import global_settings

    if not global_settings.device_guard_enabled:
        return True, "guard disabled"
    if guard.state == DeviceState.FAILED:
        return False, "device engine FAILED (rebuild retrying)"
    return True, guard.state.name


def _wal_ready() -> tuple[bool, str]:
    from .settings import global_settings
    from .wal import wal

    if not global_settings.wal_path:
        return True, "journal not configured"
    if not wal.writer_alive():
        return False, "WAL writer dead/wedged (durability lost)"
    return True, f"writer alive at seq {wal.current_seq()}"


def _trunk_ready() -> tuple[bool, str]:
    from ..federation import plane
    from ..federation.directory import directory

    if not directory.active:
        return True, "federation not armed"
    peers = directory.peers()
    if not peers:
        return True, "no peers configured"
    mgr = getattr(plane, "manager", None)
    links = getattr(mgr, "links", {}) if mgr is not None else {}
    # list() first: this probe runs on an ops HTTP thread while the
    # loop installs/drops links — a generator over the live dict would
    # race the mutation across bytecode boundaries (doc/concurrency.md).
    live = sorted(p for p, ln in list(links.items()) if ln.alive)
    quorum = (len(peers) + 1) // 2
    if len(live) < quorum:
        return False, (f"trunk quorum lost: {len(live)}/{len(peers)} "
                       f"peers linked (need {quorum})")
    return True, f"{len(live)}/{len(peers)} peers linked"


def readiness() -> tuple[bool, dict]:
    """The /readyz matrix. Every component is probed independently and
    a probe that raises reports not-ready with the error (a component
    crash must read as unready, never as a 500)."""
    components: dict[str, dict] = {}
    ready = True
    for name, probe in (
        ("shard", _shard_ready),
        ("device", _device_ready),
        ("wal", _wal_ready),
        ("trunks", _trunk_ready),
    ):
        try:
            ok, detail = probe()
        except Exception as e:
            ok, detail = False, f"probe error: {e!r}"
        components[name] = {"ok": ok, "detail": detail}
        ready = ready and ok
    return ready, components


def introspect() -> dict:
    """The /introspect census (also what fleetctl renders)."""
    from ..federation import plane
    from ..federation.directory import directory
    from .channel import all_channels
    from .connection import all_connections
    from .device_guard import guard
    from .overload import governor
    from .settings import global_settings
    from .slo import slo
    from .tracing import recorder
    from .wal import wal

    doc: dict = {
        "gateway": directory.local_id or "",
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _started_at, 1),
        "tick": recorder.tick,
    }
    try:
        channels: dict[str, int] = {}
        entities = 0
        for ch in list(all_channels().values()):
            channels[ch.channel_type.name] = \
                channels.get(ch.channel_type.name, 0) + 1
            ents = getattr(ch.get_data_message(), "entities", None)
            if ents is not None:
                entities += len(ents)
        doc["channels"] = dict(sorted(channels.items()))
        doc["entities"] = entities
    except Exception as e:
        doc["channels"] = {"error": repr(e)}
    try:
        conns: dict[str, int] = {}
        for conn in list(all_connections().values()):
            conns[conn.connection_type.name] = \
                conns.get(conn.connection_type.name, 0) + 1
        doc["connections"] = dict(sorted(conns.items()))
    except Exception as e:
        doc["connections"] = {"error": repr(e)}
    try:
        doc["overload"] = {"level": int(governor.level),
                           "pressure": round(governor.pressure, 4)}
    except Exception as e:
        doc["overload"] = {"error": repr(e)}
    try:
        doc["slo"] = slo.status() if slo.enabled else {"enabled": False}
    except Exception as e:
        doc["slo"] = {"error": repr(e)}
    try:
        doc["device"] = guard.state.name
    except Exception as e:
        doc["device"] = repr(e)
    try:
        doc["wal"] = {
            "configured": bool(global_settings.wal_path),
            "writer_alive": wal.writer_alive(),
            "seq": wal.current_seq(),
        }
    except Exception as e:
        doc["wal"] = {"error": repr(e)}
    try:
        if directory.active:
            mgr = getattr(plane, "manager", None)
            links = getattr(mgr, "links", {}) if mgr is not None else {}
            doc["federation"] = {
                "peers": directory.peers(),
                # snapshot first: ops-thread read vs loop link churn
                "live_trunks": sorted(
                    p for p, ln in list(links.items()) if ln.alive),
                "directory_version": directory.override_version,
            }
    except Exception as e:
        doc["federation"] = {"error": repr(e)}
    ready, components = readiness()
    doc["ready"] = ready
    doc["readiness"] = components
    return doc


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class _OpsHandler(BaseHTTPRequestHandler):
    server_version = "channeld-tpu-ops/1"

    def log_message(self, fmt, *args):  # quiet: probes hit every few s
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _reply_json(self, code: int, doc: dict) -> None:
        self._reply(code, json.dumps(doc, indent=1).encode(),
                    "application/json")

    def do_GET(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        _affinity.enter("ops-http")
        path, _, query = self.path.partition("?")
        try:
            if path == "/metrics":
                from prometheus_client import generate_latest

                from . import metrics

                self._reply(200, generate_latest(metrics.registry),
                            "text/plain; version=0.0.4")
            elif path == "/healthz":
                self._reply_json(200, {
                    "ok": True, "pid": os.getpid(),
                    "uptime_s": round(time.monotonic() - _started_at, 1),
                })
            elif path == "/readyz":
                ready, components = readiness()
                self._reply_json(200 if ready else 503, {
                    "ready": ready, "components": components,
                })
            elif path == "/introspect":
                self._reply_json(200, introspect())
            elif path == "/fleet":
                from ..federation.obs import fleet

                if "format=json" in query:
                    self._reply_json(200, fleet.render_json())
                else:
                    self._reply(200, fleet.render_prometheus().encode(),
                                "text/plain; version=0.0.4")
            else:
                self._reply_json(404, {"error": f"no route {path!r}"})
        except Exception as e:
            logger.exception("ops handler failed on %s", path)
            self._reply_json(500, {"error": repr(e)})


class OpsServer:
    """The threaded ops HTTP server; ``port=0`` binds an ephemeral port
    (tests — the bound port is on ``.port``)."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._httpd = ThreadingHTTPServer((host, port), _OpsHandler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ops-http", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


_server: Optional[OpsServer] = None


def serve_ops(port: int, host: str = "0.0.0.0") -> OpsServer:
    """Start (or return) the process-wide ops server. Replaces the
    bare ``serve_metrics`` in the gateway boot — /metrics is one of
    its routes, so the scrape config keeps working unchanged."""
    global _server
    if _server is None:
        _server = OpsServer(port, host)
        logger.info(
            "ops surface on :%d — /metrics /healthz /readyz /introspect "
            "/fleet (doc/observability.md)", _server.port,
        )
    return _server


def reset_ops() -> None:
    """Test hook: stop the server so the next test binds afresh."""
    global _server
    if _server is not None:
        _server.close()
        _server = None
