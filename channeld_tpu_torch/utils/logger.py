"""Logging with channeld-compatible verbosity levels.

The reference wraps zap with custom levels Verbose=-2, VeryVerbose=-3,
Trace=-4 below Debug=-1 (ref: pkg/channeld/logging.go:26-63), a separate
``security.log`` logger, and a warn+ counter metric. We map onto Python
logging: DEBUG=10 and three sub-debug levels below it.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

VERBOSE = 8
VERY_VERBOSE = 6
TRACE = 4

logging.addLevelName(VERBOSE, "VERBOSE")
logging.addLevelName(VERY_VERBOSE, "VVERBOSE")
logging.addLevelName(TRACE, "TRACE")

_ROOT_NAME = "channeld_tpu_torch"
_initialized = False
_active_format = "%(asctime)s %(levelname)-8s %(name)s: %(message)s"

# Incremented on warn+ records; mirrored into the Prometheus `logs` counter.
warn_counts: dict[str, int] = {}


class _WarnCountFilter(logging.Filter):
    """Counts warn+ records (ref: logging.go warn-hook -> `logs` metric).

    Attached to the *handler* (not the logger): records propagated from
    child loggers only pass through the parent's handlers, never the
    parent logger's own filters.
    """

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno >= logging.WARNING:
            key = logging.getLevelName(record.levelno)
            warn_counts[key] = warn_counts.get(key, 0) + 1
            try:  # lazy: metrics pulls in prometheus_client
                from ..core.metrics import log_events

                log_events.labels(level=key).inc()
            except Exception:
                pass
        return True


def init_logs(
    level: int = logging.INFO,
    log_file: Optional[str] = None,
    development: bool = False,
) -> logging.Logger:
    """Initialize the root framework logger (ref: logging.go:66-100).

    ``log_file`` may contain a ``{time}`` placeholder replaced with a
    timestamp, matching the reference's log-file pattern.
    """
    global _initialized
    root = logging.getLogger(_ROOT_NAME)
    root.handlers.clear()
    root.setLevel(level)
    global _active_format
    fmt = _active_format = (
        "%(asctime)s %(levelname)-8s %(name)s: %(message)s"
        if development
        else '{"ts":"%(asctime)s","level":"%(levelname)s","logger":"%(name)s","msg":"%(message)s"}'
    )
    handler: logging.Handler
    if log_file:
        log_file = log_file.replace("{time}", time.strftime("%Y%m%d%H%M%S"))
        handler = logging.FileHandler(log_file)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(fmt))
    handler.addFilter(_WarnCountFilter())
    root.addHandler(handler)
    root.propagate = False
    _initialized = True
    return root


def get_logger(name: str = "") -> logging.Logger:
    if not _initialized:
        init_logs()
    return logging.getLogger(f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME)


def security_logger() -> logging.Logger:
    """Separate security event stream; gets its own file next to the main
    log when file logging is configured (ref: logging.go security.log)."""
    return get_logger("security")


def attach_security_log_file(main_log_file: str) -> None:
    """Route security events to ``security.log`` beside the main log.
    Re-init safe (replaces any prior file handler) and uses the same
    format init_logs chose, like the reference's shared zap config."""
    import os

    sec = get_logger("security")
    for h in [h for h in sec.handlers if isinstance(h, logging.FileHandler)]:
        sec.removeHandler(h)
        h.close()
    path = os.path.join(os.path.dirname(main_log_file) or ".", "security.log")
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(_active_format))
    sec.addHandler(handler)
