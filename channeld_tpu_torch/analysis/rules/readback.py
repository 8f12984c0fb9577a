"""hot-readback: no per-connection device->host syncs in tick paths.

The port's restatement for torch: besides the JAX package's detectors
it flags torch's implicit syncs — ``.cpu()``, ``.numpy()``,
``.tolist()``, ``.to("cpu")``, ``int()``/``float()``/``bool()`` of a
subscript or of a tensor reduction, and ``torch.cuda.synchronize`` /
``Event.synchronize`` / ``Stream.synchronize`` — so the gateway's two
reads per steady tick (the consume and changed-rows blobs) stay two.

The bug class this rule pins: a device->host readback per connection
inside ``_apply_follow_interests``, closed in the JAX package by
batching every follower into ONE transfer
(``engine.interested_cells_batch``).  The fix only stays fixed if nobody
reintroduces an implicit sync — ``.item()``, ``np.asarray`` /
``np.array`` on engine arrays, ``float()`` over a scalar index, direct
scalar indexing of engine device arrays, or a call to the single-row
``interested_cells`` helper — inside the tick-path functions.

The allowlisted batched helpers (``interested_cells_batch``,
``handover_list``, ``undelivered_slots``) live in ``ops/engine.py``,
which is out of scope by construction: the engine owns its transfers,
the tick path must not add its own.  Designed one-transfer-per-tick
sites are baselined with a reason, not exempted by pattern.
"""

from __future__ import annotations

import ast

from ..astutil import dotted, import_aliases, iter_functions
from ..engine import Finding, ModuleInfo, RepoContext, Rule, match_scope

# (module glob, function-name regex): the tick/trunk/adoption hot paths.
HOT_PATHS: tuple[tuple[str, str], ...] = (
    ("channeld_tpu_torch/spatial/gpu_controller.py",
     r"^(tick|_apply_follow_interests|_publish_due|_reap_followers|"
     r"device_due|_recenter_followers|collapse_micro_cells)$"),
    # The standing-query plane consumes its ONE pre-fetched changed-rows
    # blob per tick (doc/query_engine.md); every function that runs on
    # the tick path must stay transfer-free — the designed fetch lives
    # in engine.query_changed_rows / the guard's _step_body with
    # reasoned disables.
    ("channeld_tpu_torch/spatial/queryplane.py",
     r"^(pump|_consume|_apply_pending|reap_closed|deregister|_install|"
     r"sensor_cells)$"),
    # Simulation plane (doc/simulation.md): the agent step is
    # device->device inside the guarded tick; the plane's ONLY readback
    # is the census-cadence batched fetch (reasoned disable in
    # on_result / the guard's prefetch) — everything else on its tick
    # path must stay transfer-free.
    ("channeld_tpu_torch/sim/plane.py",
     r"^(pre_step|on_result|_micro_cells|_on_danger_cells|"
     r"on_geometry)$"),
    ("channeld_tpu_torch/sim/authority.py", r"^(pump|commit|_attach)$"),
    # The supervised step wraps the per-tick device readbacks; its ONE
    # designed batched fetch (worker-thread _step_body) carries reasoned
    # disables, everything else in the guard must stay transfer-free.
    ("channeld_tpu_torch/core/device_guard.py",
     r"^(run_step|_step_body|_sentinel|_dispatch)$"),
    ("channeld_tpu_torch/spatial/grid.py", r"^_orchestrate"),
    ("channeld_tpu_torch/spatial/controller.py", r"^tick$"),
    ("channeld_tpu_torch/core/channel.py",
     r"^(tick_once|_tick_messages|_tick_connections|"
     r"_tick_recoverable_subscriptions)$"),
    ("channeld_tpu_torch/federation/trunk.py",
     r"^(send|_dispatch|_read_loop|_heartbeat_loop|_on_heartbeat)$"),
    ("channeld_tpu_torch/federation/plane.py",
     r"^(initiate_handover|_handle_|_on_|_commit_batch|_abort_batch|"
     r"_dst_fanout|_send_src_fanout|_reoffer_parked|_purge_local_placement)"),
    ("channeld_tpu_torch/federation/control.py",
     r"^(_epoch_tick|_on_|_process_death|_begin_|_advance_|_finalize_|"
     r"_kick_drain|_census_advance|_restore_unclaimed|_evacuate_|"
     r"_sweep_stale_rows|_replicate|_build_vector)"),
    # WAL append surface (doc/persistence.md): journal hooks run inside
    # ticks and must never force a device sync (or any I/O — fsync
    # lives on the off-thread writer, which is out of scope by design).
    ("channeld_tpu_torch/core/wal.py",
     r"^(append|note_dirty|on_global_tick|log_)"),
    # Fleet health plane: the per-tick SLO hooks and the
    # staleness sample run inside the GLOBAL tick (the 24µs hot-path
    # budget doc/observability.md pins); the digest build/attach runs
    # on the control epoch inside the tick too. The ops handlers are
    # off-loop but still must not touch engine arrays — an /introspect
    # that syncs the device would stall the worker's dispatch queue.
    ("channeld_tpu_torch/core/slo.py",
     r"^(on_global_tick|_evaluate|_feed|record_delivery|observe|"
     r"_sample_staleness|_rebuild_sample_ring)$"),
    ("channeld_tpu_torch/core/opshttp.py",
     r"^(do_GET|readiness|introspect|_shard_ready|_device_ready|"
     r"_wal_ready|_trunk_ready)$"),
    ("channeld_tpu_torch/federation/obs.py",
     r"^(build_local_digest|attach_digest|store_peer|refresh_local|"
     r"merged|merge_digests|render_)"),
)

# Calls that force a device->host transfer for ONE row/scalar.
_SINGLE_ROW_CALLS = {"interested_cells"}
# numpy entry points that materialize a device array on host.
_NP_MATERIALIZE = {"asarray", "array", "unpackbits", "copy"}
# Tensor methods that copy to the host (and wait for the device).
_TENSOR_TO_HOST = {"cpu", "numpy", "tolist"}
# Tensor reductions whose int()/float()/bool() reads one scalar back.
_REDUCTIONS = {"any", "all", "sum", "max", "min", "count_nonzero", "numel"}


def _is_scalar_of_tensor(arg: ast.AST) -> bool:
    """An argument of int()/float()/bool() that is a device scalar: a
    subscript, a tensor reduction (``x.any()``), or a ``torch.*`` call."""
    if isinstance(arg, ast.Subscript):
        return True
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute):
        name = dotted(arg.func) or ""
        return arg.func.attr in _REDUCTIONS or name.startswith("torch.")
    return False


def _is_engine_chain(node: ast.AST) -> bool:
    """True for attribute chains rooted in an engine reference
    (``self.engine.X`` / ``engine.X``)."""
    name = dotted(node)
    return name is not None and (".engine." in f".{name}.")


class HotPathReadbackRule(Rule):
    name = "hot-readback"
    description = (
        "no implicit device->host syncs (.item(), .cpu(), .numpy(), "
        ".tolist(), .to('cpu'), np.asarray/np.array on tensors, int/"
        "float/bool of a tensor scalar, torch.cuda/Event/Stream "
        ".synchronize(), scalar indexing, single-row interested_cells) "
        "in tick-path functions outside allowlisted batched helpers"
    )

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        hot = [fn for fn in iter_functions(mod.tree)
               if match_scope(mod.rel, fn.name, HOT_PATHS)]
        if not hot:
            return []
        aliases = import_aliases(mod.tree)
        np_names = {local for local, target in aliases.items()
                    if target.lstrip(".") == "numpy"}
        findings: list[Finding] = []

        def flag(node: ast.AST, scope: str, detector: str, msg: str) -> None:
            # Hot functions can lexically contain one another's scan
            # roots (a nested def that itself matches the scope table):
            # dedupe by site so one expression flags once.
            if (node.lineno, detector) in seen:
                return
            seen.add((node.lineno, detector))
            findings.append(Finding(
                rule=self.name, path=mod.rel, line=node.lineno,
                message=msg, detector=detector, scope=scope,
            ))

        seen: set[tuple[int, str]] = set()

        for fn in hot:
            # Full walk INCLUDING nested defs/lambdas: a helper defined
            # inside tick() and called per connection performs its
            # readback on the hot path all the same (the async-blocking
            # rule covers nesting via FuncInfo.in_async; here the scope
            # is the hot function itself).
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    func = node.func
                    if isinstance(func, ast.Attribute):
                        if func.attr == "item" and not node.args:
                            flag(node, fn.qualname, ".item()",
                                 ".item() forces a device->host sync per "
                                 "call")
                        elif func.attr in _TENSOR_TO_HOST and not node.args:
                            flag(node, fn.qualname, f".{func.attr}()",
                                 f".{func.attr}() copies a tensor to the "
                                 "host and waits for the device")
                        elif (func.attr == "to" and node.args
                              and isinstance(node.args[0], ast.Constant)
                              and node.args[0].value == "cpu"):
                            flag(node, fn.qualname, ".to('cpu')",
                                 ".to('cpu') copies a tensor to the host "
                                 "and waits for the device")
                        elif func.attr == "synchronize":
                            flag(node, fn.qualname, ".synchronize()",
                                 f"{dotted(func) or '.synchronize'}() "
                                 "waits for the device: the host stalls "
                                 "behind every queued launch")
                        elif func.attr in _SINGLE_ROW_CALLS:
                            flag(node, fn.qualname, f".{func.attr}()",
                                 f"single-row {func.attr}() reads back one "
                                 "device row per connection; use "
                                 "interested_cells_batch (ONE transfer "
                                 "per pass)")
                        elif (
                            func.attr in _NP_MATERIALIZE
                            and isinstance(func.value, ast.Name)
                            and func.value.id in np_names
                        ):
                            flag(node, fn.qualname, f"np.{func.attr}",
                                 f"np.{func.attr}() on a device array is "
                                 "an implicit device->host transfer")
                    elif (
                        isinstance(func, ast.Name)
                        and func.id in ("float", "int", "bool")
                        and node.args
                        and _is_scalar_of_tensor(node.args[0])
                    ):
                        what = ("subscript" if isinstance(node.args[0], ast.Subscript)
                                else "tensor")
                        flag(node, fn.qualname, f"{func.id}({what})",
                             f"{func.id}() of a device scalar reads it "
                             "back per call; batch the transfer")
                elif isinstance(node, ast.Subscript):
                    if _is_engine_chain(node.value):
                        flag(node, fn.qualname, "engine-subscript",
                             "scalar indexing of an engine array syncs "
                             "device->host per element; fetch the batch "
                             "once")
        return findings
