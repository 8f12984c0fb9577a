"""Runtime thread-affinity assertions: the thread model's twin.

``analysis/threadmodel.py`` is a *static* claim about which execution
domain every function runs in; this module is the cheap runtime checker
that validates the claim against reality (doc/concurrency.md).  The
domain names are the same on both sides — ``tests/test_affinity.py``
pins that the two tables agree — so a static-model drift and a runtime
drift cannot diverge silently.

Semantics:

- Domains map to OS *threads*: every loop domain (tick-loop,
  trunk-reader, boot-loop) collapses onto the one loop thread; each
  own-thread domain is its own (:data:`DOMAIN_THREADS`).
- A domain's **entry point** calls :func:`enter` — it (re)binds the
  domain's thread key to the current thread ident.  The WAL writer
  binds ``wal-writer`` at loop start, the device worker binds
  ``device-worker`` per body, the GLOBAL tick re-binds ``loop`` every
  tick (so a fresh event loop in a new test rebinds cleanly).
- A function that must only run in a domain calls :func:`expect` — a
  mismatch against the bound ident is a **violation**: recorded (with
  the call site), counted, warned once per site, and raised when
  ``strict``.  An unbound domain auto-binds (the checker observes
  reality before it enforces it).

Disarmed (the default in production) every hook is ONE attribute load.
Tier-1 arms the checker for the whole run (tests/conftest.py) and
fails any test that produced a violation; ``-debug-affinity`` arms it
on a live gateway.
"""

from __future__ import annotations

import threading

from ..utils.logger import get_logger

logger = get_logger("affinity")

# Domain -> thread key. MUST mirror analysis/threadmodel.py DOMAINS
# (loop domains share the loop thread; own-thread domains are their
# own key). tests/test_affinity.py asserts the two tables agree.
DOMAIN_THREADS: dict[str, str] = {
    "tick-loop": "loop",
    "trunk-reader": "loop",
    "boot-loop": "loop",
    "wal-writer": "wal-writer",
    "device-worker": "device-worker",
    "trace-dumper": "trace-dumper",
    "ops-http": "ops-http",
    "grpc-pool": "grpc-pool",
    "loop-offload": "loop-offload",
}


class AffinityViolation(AssertionError):
    pass


class AffinityChecker:
    """Process-wide checker (one instance: ``affinity``)."""

    def __init__(self):
        self.armed = False
        self.strict = False
        self.reset()

    def reset(self) -> None:
        """Drop every binding and recorded violation (test hook; also
        safe live — domains re-bind on their next entry)."""
        self._bound: dict[str, int] = {}
        self.violations: list[dict] = []
        self._warned: set[tuple] = set()

    def arm(self, strict: bool = False) -> None:
        self.reset()
        self.armed = True
        self.strict = strict

    def disarm(self) -> None:
        self.armed = False
        self.reset()

    # ---- the two hooks (hot paths guard on .armed: one attr load) --------

    def enter(self, domain: str) -> None:
        """The current thread IS ``domain``'s thread from here on —
        called by the domain's entry point (thread body / handler /
        the GLOBAL tick). Re-binding is the point: a fresh writer
        thread or a new event loop takes the binding over."""
        if not self.armed:
            return
        self._bound[DOMAIN_THREADS[domain]] = threading.get_ident()

    def expect(self, domain: str) -> None:
        """Assert the caller is on ``domain``'s bound thread. Unbound
        auto-binds (observe first, enforce after)."""
        if not self.armed:
            return
        key = DOMAIN_THREADS[domain]
        ident = threading.get_ident()
        bound = self._bound.get(key)
        if bound is None:
            self._bound[key] = ident
            return
        if bound != ident:
            self._violate(domain, key, bound, ident)

    # ---- violation plumbing ----------------------------------------------

    def _violate(self, domain: str, key: str, bound: int,
                 ident: int) -> None:
        import sys

        frame = sys._getframe(2)
        where = f"{frame.f_code.co_filename}:{frame.f_lineno}"
        names = {t.ident: t.name for t in threading.enumerate()}
        record = {
            "domain": domain,
            "thread_key": key,
            "bound": names.get(bound, str(bound)),
            "actual": names.get(ident, str(ident)),
            "where": where,
        }
        self.violations.append(record)
        del self.violations[:-256]
        site = (domain, where)
        if site not in self._warned:
            self._warned.add(site)
            logger.warning(
                "thread-affinity violation: %s code ran on thread %r "
                "(bound to %r) at %s (doc/concurrency.md)",
                domain, record["actual"], record["bound"], where,
            )
        if self.strict:
            raise AffinityViolation(
                f"{domain} code on thread {record['actual']!r} "
                f"(bound {record['bound']!r}) at {where}"
            )

    def report(self) -> dict:
        return {
            "armed": self.armed,
            "strict": self.strict,
            "bound": dict(self._bound),
            "violations": list(self.violations),
        }


# The process-wide checker. Hook sites hold a module reference and the
# disarmed cost is one attribute load.
affinity = AffinityChecker()


def configure_from_settings() -> None:
    """Apply the -debug-affinity flag (run_server boot path)."""
    from .settings import global_settings as st

    if st.debug_affinity:
        affinity.arm(strict=False)
        logger.info(
            "runtime thread-affinity assertions ARMED (-debug-affinity): "
            "violations are recorded and warned, not raised "
            "(doc/concurrency.md)",
        )


def reset_affinity() -> None:
    """Test hook."""
    affinity.disarm()
