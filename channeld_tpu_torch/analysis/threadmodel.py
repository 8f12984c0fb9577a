"""The gateway's declarative thread model (doc/concurrency.md).

The gateway stopped being single-threaded several PRs ago: the asyncio
loop carries the GLOBAL tick, trunk I/O and every channel mutation, but
the WAL writer (core/wal.py), the device-guard worker pool
(core/device_guard.py), the flight recorder's anomaly dump thread
(core/tracing.py), the ops HTTP server (core/opshttp.py) and the gRPC
sidecar executor (ops/service.py) all run off-loop.  Every one of those
threads has a *discipline* — what it may touch, how state crosses the
boundary — that was previously enforced only by review.  This module is
the machine-readable form of that discipline:

- **Execution domains** (:data:`DOMAINS`): the named contexts code runs
  in.  Loop-thread domains (``tick-loop``, ``trunk-reader``,
  ``boot-loop``) share one OS thread; own-thread domains (wal-writer,
  device-worker, trace-dumper, ops-http, grpc-pool, loop-offload) each
  have their own.  ``steady`` marks the domains where blocking stalls
  live traffic (boot/shutdown on the loop may block; a tick may not).
- **Entry-point inference**: ``threading.Thread(target=...)``,
  ``executor.submit(fn, ...)``, ``asyncio.to_thread(fn, ...)`` and
  ``loop.run_in_executor(_, fn, ...)`` sites are scanned; every thread
  entry point must be claimed by a domain's ``seeds`` (or the creation
  site by its ``spawn_sites``) — an undeclared thread is a
  ``thread-model`` finding, so a new thread cannot appear without
  extending this spec.
- **A call-graph pass** assigns every function the set of domains it is
  reachable from.  Resolution is name-based and deliberately pragmatic:
  ``self.x()`` resolves within the enclosing module's classes, bare
  names within the module (nested defs included) and via from-imports,
  and attribute calls through the :data:`INSTANCES` table of the
  project's module-level singletons (``wal`` -> WriteAheadLog, ``guard``
  -> DeviceGuard, ...).  Calls into an ``async def`` propagate only when
  awaited — ``ensure_future(coro())`` schedules a new task in the
  callee's own domain, it does not run the body in the caller's.

The affinity rules (analysis/rules/affinity.py) and the extended
async-blocking rule consume the model; ``core/affinity.py`` is its
runtime twin (the same domain names compile to thread-ident assertions
armed in tier-1), and ``tests/test_affinity.py`` pins that the two
agree.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from dataclasses import dataclass, field

from .astutil import call_name, dotted, import_aliases, iter_functions
from .engine import ModuleInfo, RepoContext

# Modules the model covers: the planes that actually host or touch
# threads.  models/, compat/, replay/, client/, parallel/ and protocol/
# stay out of scope — they run in tests, sidecars or pure device code.
SCAN_GLOBS = (
    "channeld_tpu_torch/core/*.py",
    "channeld_tpu_torch/federation/*.py",
    "channeld_tpu_torch/spatial/*.py",
    "channeld_tpu_torch/ops/*.py",
    "channeld_tpu_torch/chaos/*.py",
    "channeld_tpu_torch/sim/*.py",
)

# Handoff mechanisms a ``# tpulint: shared=<mechanism>`` declaration may
# name (doc/concurrency.md#handoff-mechanisms).
SHARED_MECHANISMS = ("lock", "queue", "fence", "atomic", "cond", "event")


@dataclass(frozen=True)
class Domain:
    """One execution domain.  ``thread`` is ``"loop"`` (shares the
    asyncio loop's OS thread) or ``"own"``; ``steady`` marks the
    steady-state serving domains where a blocking call stalls live
    traffic (boot-loop blocks legitimately: listeners are not open)."""

    name: str
    thread: str
    steady: bool = False
    # ((module glob, qualname regex), ...): functions IN the domain —
    # thread bodies, handler methods, or the loop-side tick drivers.
    seeds: tuple = ()
    # Creation sites allowed to spawn this domain's threads even when
    # the target is not a project function (e.g. the ops server hands
    # the stdlib serve_forever to its thread).
    spawn_sites: tuple = ()
    doc: str = ""


DOMAINS: tuple[Domain, ...] = (
    Domain(
        "tick-loop", thread="loop", steady=True,
        seeds=(
            ("channeld_tpu_torch/core/channel.py", r"^Channel\.tick_once$"),
            ("channeld_tpu_torch/spatial/gpu_controller.py",
             r"^GPUSpatialController\.tick$"),
            # Standing-query plane (doc/query_engine.md): consume/apply
            # runs inside the controller tick; seeded explicitly because
            # the attribute hop (self.queryplane.pump) is not a
            # module-singleton call the propagator can resolve.
            ("channeld_tpu_torch/spatial/queryplane.py",
             r"^QueryPlane\.(pump|reap_closed)$"),
            # Simulation plane (doc/simulation.md): cadence/absorb
            # hooks run inside the controller tick; seeded explicitly
            # for the same attribute-hop reason (self.simplane.pre_step
            # / on_result are plain instance fields).
            ("channeld_tpu_torch/sim/plane.py",
             r"^SimPlane\.(pre_step|on_result|activate)$"),
            ("channeld_tpu_torch/sim/authority.py",
             r"^SimAuthority\.(pump|commit|adopt)$"),
            ("channeld_tpu_torch/spatial/grid.py",
             r"^StaticGrid2DSpatialController\.tick$"),
            ("channeld_tpu_torch/core/connection.py", r"^Connection\.on_bytes$"),
            # asyncio transport/protocol callbacks are sync functions
            # the loop invokes directly — seed them or the ingest path
            # would be invisible to the model.
            ("channeld_tpu_torch/core/*.py",
             r"\.(data_received|datagram_received|connection_made|"
             r"connection_lost|eof_received|error_received)$"),
            # Registry-dispatched message handlers (core/message.py
            # MESSAGE_MAP): invoked through a dict the call-graph pass
            # cannot follow, but they run inside the channel tick's
            # message drain all the same.
            ("channeld_tpu_torch/core/message.py", r"^handle_"),
            # Control-plane work deferred INTO the GLOBAL tick via
            # _in_global_tick (callable queue — another registry hop).
            ("channeld_tpu_torch/federation/control.py",
             r"^GlobalControlPlane\._epoch_tick$"),
        ),
        doc="the asyncio event loop's steady state: GLOBAL tick, channel "
            "ticks, message dispatch, fan-out, controller/device "
            "orchestration (every async def in scope defaults here)",
    ),
    Domain(
        "trunk-reader", thread="loop", steady=True,
        seeds=(
            ("channeld_tpu_torch/federation/trunk.py",
             r"^(TrunkLink\._read_loop|TrunkLink\._heartbeat_loop|"
             r"TrunkManager\._dial_loop|TrunkManager\._on_accept)$"),
            # Trunk callbacks installed at construction (the link holds
            # them as fields, so the call-graph pass cannot follow the
            # dispatch): the federation plane's message/up/down hooks
            # and the control plane's trunk-facing handlers.
            ("channeld_tpu_torch/federation/plane.py",
             r"^FederationPlane\._on_trunk_"),
            ("channeld_tpu_torch/federation/control.py",
             r"^GlobalControlPlane\.(on_trunk_message|on_trunk_up|"
             r"on_peer_goodbye)$"),
        ),
        doc="trunk ingress/heartbeat tasks — same OS thread as the tick "
            "loop (asyncio tasks), named separately because their "
            "handlers are the federation hot path",
    ),
    Domain(
        "boot-loop", thread="loop", steady=False,
        seeds=(
            ("channeld_tpu_torch/core/server.py",
             r"^(run_server|drain_gateway)$"),
            # The SIGTERM drain task and its closures: shutdown code on
            # the loop, not steady serving.
            ("channeld_tpu_torch/core/server.py", r"^install_sigterm_drain\."),
        ),
        doc="gateway boot and SIGTERM drain on the loop thread before/"
            "after steady serving — blocking I/O is acceptable here "
            "(listeners are closed), so the blocking rules exempt it",
    ),
    Domain(
        "wal-writer", thread="own", steady=False,
        seeds=(
            ("channeld_tpu_torch/core/wal.py",
             r"^WriteAheadLog\._writer_loop$"),
        ),
        doc="the journal's dedicated writer thread: frames, writes and "
            "fsyncs record batches (doc/persistence.md)",
    ),
    Domain(
        "device-worker", thread="own", steady=False,
        seeds=(
            ("channeld_tpu_torch/core/device_guard.py",
             r"^DeviceGuard\._(step_body|rebuild_body)$"),
        ),
        doc="the device guard's watchdogged worker: the engine step, "
            "its batched readbacks, and the in-process rebuild "
            "(doc/device_recovery.md)",
    ),
    Domain(
        "trace-dumper", thread="own", steady=False,
        seeds=(
            ("channeld_tpu_torch/core/tracing.py",
             r"^FlightRecorder\.note_anomaly\._write$"),
        ),
        doc="anomaly-dump writer threads: Perfetto JSON formatting and "
            "disk I/O off the tick that tripped the anomaly",
    ),
    Domain(
        "ops-http", thread="own", steady=False,
        seeds=(
            ("channeld_tpu_torch/core/opshttp.py", r"^_OpsHandler\."),
            ("channeld_tpu_torch/core/opshttp.py",
             r"^(readiness|introspect|_shard_ready|_device_ready|"
             r"_wal_ready|_trunk_ready)$"),
        ),
        spawn_sites=(
            ("channeld_tpu_torch/core/opshttp.py", r"^OpsServer\.__init__$"),
        ),
        doc="the threaded ops HTTP server (/metrics /healthz /readyz "
            "/introspect /fleet): handler threads take snapshot reads "
            "of loop-owned state, never mutate it",
    ),
    Domain(
        "grpc-pool", thread="own", steady=False,
        seeds=(
            ("channeld_tpu_torch/ops/service.py",
             r"^SpatialDecisionServicer\."),
        ),
        spawn_sites=(
            ("channeld_tpu_torch/ops/service.py", r"^create_server$"),
        ),
        doc="the gRPC sidecar executor pool (ops/service.py): servicer "
            "methods own a sidecar engine, not the gateway's",
    ),
    Domain(
        "loop-offload", thread="own", steady=False,
        doc="asyncio.to_thread / run_in_executor targets: blocking work "
            "the loop explicitly shipped to the default executor "
            "(membership is inferred, never declared)",
    ),
)

DOMAINS_BY_NAME = {d.name: d for d in DOMAINS}

# Module-level singletons: an attribute call through one of these names
# resolves to the owning class's method.  (name -> ((module rel suffix,
# class name or None for any class in the module), ...)).
INSTANCES: dict[str, tuple] = {
    "wal": (("core/wal.py", "WriteAheadLog"),),
    "guard": (("core/device_guard.py", "DeviceGuard"),),
    "recorder": (("core/tracing.py", "FlightRecorder"),),
    "slo": (("core/slo.py", "SloPlane"),),
    "governor": (("core/overload.py", "OverloadGovernor"),),
    "plane": (("federation/plane.py", "FederationPlane"),),
    "control": (("federation/control.py", "GlobalControlPlane"),),
    "directory": (("federation/directory.py", "ShardDirectory"),),
    "fleet": (("federation/obs.py", "FleetObs"),),
    "chaos": (("chaos/injector.py", "ChaosInjector"),),
    "balancer": (("spatial/balancer.py", "BalancerPlane"),),
    "partition": (("spatial/partition.py", "PartitionPlane"),),
    "engine": (("ops/engine.py", "SpatialEngine"),),
    # SLO per-second rings: not singletons, but the one non-singleton
    # hop that crosses threads (the WAL writer feeds wal_fsync events).
    "ring": (("core/slo.py", "_WindowRing"),),
    "controller": (
        ("spatial/gpu_controller.py", None),
        ("spatial/grid.py", None),
    ),
}


@dataclass
class ThreadSite:
    """One thread/executor entry-point creation site."""

    rel: str
    line: int
    kind: str            # "thread" | "submit" | "to_thread" | "executor"
    site: str            # qualname of the function containing the call
    target_repr: str     # source-ish description of the target
    targets: list        # resolved (rel, qualname) keys (may be empty)
    declared: bool = False


@dataclass
class ThreadModel:
    # (rel, qualname) -> frozenset of domain names the function is
    # reachable from (empty set == unreached: tests/scripts only).
    fn_domains: dict = field(default_factory=dict)
    functions: dict = field(default_factory=dict)   # key -> FuncInfo
    sites: list = field(default_factory=list)       # [ThreadSite]
    stale_seeds: list = field(default_factory=list)  # [(domain, glob, re)]

    def domains_of(self, rel: str, qualname: str) -> frozenset:
        return self.fn_domains.get((rel, qualname), frozenset())

    def is_steady_loop(self, domains) -> bool:
        return any(
            DOMAINS_BY_NAME[d].thread == "loop" and DOMAINS_BY_NAME[d].steady
            for d in domains
        )

    def off_loop(self, domains):
        """The own-thread domains in ``domains`` (sorted)."""
        return sorted(
            d for d in domains if DOMAINS_BY_NAME[d].thread == "own"
        )

    def threads_of(self, domains) -> set:
        """Distinct OS threads for a domain set: loop domains collapse
        onto one thread; each own-thread domain is its own."""
        return {
            "loop" if DOMAINS_BY_NAME[d].thread == "loop" else d
            for d in domains
        }

    def stats(self) -> dict:
        """Per-domain reachable-function counts (the --json payload and
        the doc/concurrency.md drift gate)."""
        counts = {d.name: 0 for d in DOMAINS}
        for domains in self.fn_domains.values():
            for d in domains:
                counts[d] += 1
        return counts


def in_scope(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, g) for g in SCAN_GLOBS)


def _seed_domains(rel: str, qualname: str) -> set:
    out = set()
    for dom in DOMAINS:
        for glob, pattern in dom.seeds:
            if fnmatch.fnmatch(rel, glob) and re.search(pattern, qualname):
                out.add(dom.name)
    return out


def _spawn_site_ok(rel: str, qualname: str) -> bool:
    for dom in DOMAINS:
        for glob, pattern in dom.spawn_sites:
            if fnmatch.fnmatch(rel, glob) and re.search(pattern, qualname):
                return True
    return False


class _ModuleIndex:
    """Per-module lookup tables for call resolution."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.aliases = import_aliases(mod.tree)
        self.functions: dict[str, object] = {}   # qualname -> FuncInfo
        self.classes: set[str] = {
            n.name for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)
        }
        self.methods: dict[str, list[str]] = {}  # method name -> [qualname]
        self.toplevel: set[str] = set()
        for fn in iter_functions(mod.tree):
            self.functions[fn.qualname] = fn
            parts = fn.qualname.split(".")
            if len(parts) == 1:
                self.toplevel.add(fn.qualname)
            elif len(parts) == 2 and parts[0] in self.classes:
                self.methods.setdefault(parts[1], []).append(fn.qualname)


def _build_indices(repo: RepoContext) -> dict[str, _ModuleIndex]:
    return {
        m.rel: _ModuleIndex(m) for m in repo.modules if in_scope(m.rel)
    }


def _module_by_suffix(indices: dict, suffix: str):
    for rel, idx in indices.items():
        if rel.endswith(suffix):
            return rel, idx
    return None, None


def _module_by_name(indices: dict, name: str):
    """The scanned module whose filename is ``<name>.py``."""
    return _module_by_suffix(indices, f"/{name}.py")


def _resolve_call(
    canonical: str | None,
    raw: str | None,
    caller_qual: str,
    rel: str,
    idx: _ModuleIndex,
    indices: dict,
) -> list:
    """Resolve one call to candidate (rel, qualname) keys."""
    out: list = []
    name = canonical or raw
    if not name:
        return out
    parts = name.lstrip(".").split(".")
    # self.meth() / cls.meth(): any same-module class method (base-class
    # methods live in the same module for every class this model cares
    # about; over-approximation is safe — domains only widen).
    if raw is not None and raw.split(".")[0] in ("self", "cls") \
            and len(raw.split(".")) == 2:
        meth = raw.split(".")[1]
        for qual in idx.methods.get(meth, ()):
            out.append((rel, qual))
        if out:
            return out
    if len(parts) == 1:
        # Bare name: nested def of the caller, then enclosing scopes,
        # then module level.
        scopes = caller_qual.split(".")
        for depth in range(len(scopes), -1, -1):
            prefix = ".".join(scopes[:depth])
            qual = f"{prefix}.{parts[0]}" if prefix else parts[0]
            if qual in idx.functions:
                return [(rel, qual)]
        return out
    owner, meth = parts[-2], parts[-1]
    # A singleton instance (wal.append, self.engine.tick, _slo.observe
    # via its canonical module path).
    if owner in INSTANCES:
        for suffix, cls in INSTANCES[owner]:
            target_rel, target_idx = _module_by_suffix(indices, suffix)
            if target_idx is None:
                continue
            if cls is None:
                for qual in target_idx.methods.get(meth, ()):
                    out.append((target_rel, qual))
            elif f"{cls}.{meth}" in target_idx.functions:
                out.append((target_rel, f"{cls}.{meth}"))
        if out:
            return out
    # Module-level function of a scanned module (``snapshot.write_...``
    # or from-import canonical "..core.snapshot.write_snapshot").
    target_rel, target_idx = _module_by_name(indices, owner)
    if target_idx is not None and meth in target_idx.toplevel:
        return [(target_rel, meth)]
    # Same-module class attribute (ClassName.method) references.
    if owner in idx.classes and f"{owner}.{meth}" in idx.functions:
        return [(rel, f"{owner}.{meth}")]
    return out


def _call_targets_in(fn_node: ast.AST):
    """(call node, awaited) pairs lexically inside ``fn_node`` but not
    inside a nested def (lambdas run inline and are included)."""
    awaited_ids = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
            awaited_ids.add(id(node.value))

    out = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, ast.Call):
                out.append((child, id(child) in awaited_ids))
            walk(child)

    walk(fn_node)
    return out


def _target_keys(node: ast.AST, caller_qual: str, rel: str,
                 idx: _ModuleIndex, indices: dict) -> list:
    """Resolve a callable REFERENCE (Thread target, submit arg)."""
    name = dotted(node)
    if name is None:
        return []
    head = name.split(".")[0]
    if head in ("self", "cls") or head not in idx.aliases:
        canonical = name if head not in ("self", "cls") else None
        return _resolve_call(canonical, name, caller_qual, rel, idx, indices)
    canonical = idx.aliases.get(head)
    rest = name.split(".", 1)[1] if "." in name else ""
    full = f"{canonical.lstrip('.')}.{rest}" if rest else canonical.lstrip(".")
    return _resolve_call(full, name, caller_qual, rel, idx, indices)


def _scan_thread_sites(rel: str, idx: _ModuleIndex, indices: dict) -> list:
    """Thread/executor entry-point creation sites in one module."""
    sites: list[ThreadSite] = []
    enclosing: dict[int, str] = {}
    for fn in iter_functions(idx.mod.tree):
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                enclosing.setdefault(id(node), fn.qualname)
    for node in ast.walk(idx.mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node, idx.aliases) or ""
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        site_fn = enclosing.get(id(node), "<module>")
        kind = target = None
        if name == "threading.Thread" or name == "Thread":
            kind = "thread"
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
        elif attr == "submit" and node.args:
            kind = "submit"
            target = node.args[0]
        elif name == "asyncio.to_thread" and node.args:
            kind = "to_thread"
            target = node.args[0]
        elif attr == "run_in_executor" and len(node.args) >= 2:
            kind = "executor"
            target = node.args[1]
        if kind is None:
            continue
        targets = (
            _target_keys(target, site_fn, rel, idx, indices)
            if target is not None else []
        )
        sites.append(ThreadSite(
            rel=rel, line=node.lineno, kind=kind, site=site_fn,
            target_repr=(dotted(target) or "<expr>")
            if target is not None else "<none>",
            targets=targets,
        ))
    return sites


def build_model(repo: RepoContext) -> ThreadModel:
    """Build (and cache on ``repo``) the thread model."""
    cached = getattr(repo, "_thread_model", None)
    if cached is not None:
        return cached
    indices = _build_indices(repo)
    model = ThreadModel()

    # ---- seeds -----------------------------------------------------------
    seeds: dict[tuple, set] = {}
    for rel, idx in indices.items():
        for qual, fn in idx.functions.items():
            key = (rel, qual)
            model.functions[key] = fn
            doms = _seed_domains(rel, qual)
            if not doms and fn.is_async:
                # Every unclaimed coroutine in scope runs as a loop
                # task: the tick-loop default.
                doms = {"tick-loop"}
            if doms:
                seeds[key] = doms

    # Stale spec entries: a seed whose module is present but matches no
    # function would silently hollow out the model (a rename rots the
    # discipline) — surfaced as findings by the thread-model rule.
    for dom in DOMAINS:
        for glob, pattern in dom.seeds:
            matched_mod = False
            matched_fn = False
            for rel, idx in indices.items():
                if not fnmatch.fnmatch(rel, glob):
                    continue
                matched_mod = True
                if any(re.search(pattern, q) for q in idx.functions):
                    matched_fn = True
                    break
            if matched_mod and not matched_fn:
                model.stale_seeds.append((dom.name, glob, pattern))

    # ---- thread-site scan + inferred offload membership ------------------
    for rel, idx in indices.items():
        model.sites.extend(_scan_thread_sites(rel, idx, indices))
    for site in model.sites:
        if site.kind in ("to_thread", "executor"):
            site.declared = True
            for key in site.targets:
                seeds.setdefault(key, set()).add("loop-offload")
            continue
        declared = _spawn_site_ok(site.rel, site.site)
        for key in site.targets:
            if _seed_domains(*key):
                declared = True
        site.declared = declared

    # ---- call edges ------------------------------------------------------
    edges: dict[tuple, list] = {}
    for rel, idx in indices.items():
        for qual, fn in idx.functions.items():
            targets: list = []
            for call, awaited in _call_targets_in(fn.node):
                canonical = call_name(call, idx.aliases)
                raw = dotted(call.func)
                for key in _resolve_call(canonical, raw, qual, rel, idx,
                                         indices):
                    callee = model.functions.get(key)
                    if callee is None:
                        continue
                    if callee.is_async and not awaited:
                        # ensure_future(coro()) / create_task(coro()):
                        # a NEW task in the callee's own domain — the
                        # caller's domain does not follow the call.
                        continue
                    targets.append(key)
            if targets:
                edges[(rel, qual)] = targets

    # ---- propagation -----------------------------------------------------
    fn_domains: dict[tuple, set] = {k: set(v) for k, v in seeds.items()}
    work = [(k, set(v)) for k, v in fn_domains.items()]
    while work:
        key, doms = work.pop()
        for callee in edges.get(key, ()):
            have = fn_domains.setdefault(callee, set())
            new = doms - have
            if new:
                have |= new
                work.append((callee, new))
    model.fn_domains = {
        k: frozenset(v) for k, v in fn_domains.items() if v
    }
    repo._thread_model = model
    return model
