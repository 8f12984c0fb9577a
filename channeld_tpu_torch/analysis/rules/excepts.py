"""except-hygiene: no silently swallowed broad excepts in hot paths.

A ``except Exception: pass`` in a tick, trunk or adoption path turns a
real failure (an undecodable frame, a half-applied handover, a device
error) into an invisible one — the soak's accounting then disagrees
with reality with nothing on the record.  In scope paths a broad
except must leave a trace: re-raise, bump a metric, log at warning+
(warn+ records feed the ``logs`` metric), or open a flight-recorder
span/event.  ``logger.debug`` does not count — it is off the record at
default levels.
"""

from __future__ import annotations

import ast

from ..astutil import dotted, iter_functions
from ..engine import Finding, ModuleInfo, RepoContext, Rule, match_scope

# Same shape as readback's HOT_PATHS, broadened to every trunk/adoption
# handler plus channel tick internals: the paths where accounting
# exactness is soak-asserted.
SCOPE: tuple[tuple[str, str], ...] = (
    ("channeld_tpu_torch/spatial/gpu_controller.py",
     r"^(tick|_apply_follow_interests|_publish_due|_reap_followers|"
     r"_recenter_followers|collapse_micro_cells)$"),
    # Standing-query plane (doc/query_engine.md): the consume/apply pass
    # runs inside the GLOBAL tick and its ledgers are double-entry — a
    # swallowed failure desynchronizes ledger from metric and the soak's
    # exactness assertion lies.
    ("channeld_tpu_torch/spatial/queryplane.py",
     r"^(pump|_consume|_apply_pending|reap_closed|deregister|_install|"
     r"_journal|restore_rows)$"),
    # Simulation plane (doc/simulation.md): cadence/census hooks run
    # inside the GLOBAL tick with double-entry ledgers — a swallowed
    # failure desynchronizes ledger from metric and the sim soak's
    # exactness assertion lies.
    ("channeld_tpu_torch/sim/plane.py",
     r"^(pre_step|on_result|activate|on_agents_adopted|"
     r"on_agents_departed)$"),
    ("channeld_tpu_torch/sim/authority.py", r"^(pump|commit)$"),
    ("channeld_tpu_torch/spatial/grid.py", r"^_orchestrate"),
    ("channeld_tpu_torch/spatial/controller.py", r"^tick$"),
    ("channeld_tpu_torch/core/channel.py",
     r"^(tick_once|_tick_messages|_tick_connections|"
     r"_tick_recoverable_subscriptions|_deliver_forward_batch)$"),
    ("channeld_tpu_torch/federation/trunk.py",
     r"^(send|_dispatch|_read_loop|_heartbeat_loop|_on_heartbeat)$"),
    ("channeld_tpu_torch/federation/plane.py",
     r"^(initiate_handover|_handle_|_on_|_commit_batch|_abort_batch|"
     r"_dst_fanout|_send_src_fanout|_reoffer_parked|_flush_abort_notices)"),
    ("channeld_tpu_torch/federation/control.py",
     r"^(_epoch_tick|_on_|_process_death|_begin_|_advance_|_finalize_|"
     r"_kick_drain|_census_advance|_restore_unclaimed|_evacuate_|"
     r"_replicate|_check_|_announce_resurrection|_yield_shard)"),
    # WAL hook surface (doc/persistence.md): these run on the tick path
    # — a swallowed failure here silently un-journals a transition and
    # the crash soak's exactness evaporates. The writer thread
    # (_writer_loop/_rewrite) is out of scope by design: it owns its
    # I/O error handling and never runs on the tick path.
    ("channeld_tpu_torch/core/wal.py",
     r"^(append|note_dirty|on_global_tick|log_|_count_)"),
    # Fleet health plane (doc/observability.md): the SLO
    # evaluation + staleness sample run inside the GLOBAL tick and the
    # breach ledger is double-entry — a swallowed failure here makes
    # the soak's ledger==metric assertion lie. The ops probes
    # (core/opshttp.py readiness/introspect) are the matching runtime
    # surface: a component probe that swallows its error reports a
    # half-truth to the orchestrator.
    ("channeld_tpu_torch/core/slo.py",
     r"^(on_global_tick|_evaluate|_feed|record_delivery|observe|"
     r"_sample_staleness|_rebuild_sample_ring|_count_breach)$"),
    ("channeld_tpu_torch/core/opshttp.py",
     r"^(do_GET|readiness|introspect|_shard_ready|_device_ready|"
     r"_wal_ready|_trunk_ready)$"),
    ("channeld_tpu_torch/federation/obs.py",
     r"^(attach_digest|store_peer|refresh_local|merged|render_)"),
    # Adversarial edge plane (doc/edge_hardening.md): the receive
    # path and the edge ladder run uncaught on the event loop — a
    # swallowed failure here is precisely the "parse failure becomes
    # gateway-fatal" defect class the wire fuzzer hunts, so every broad
    # except must stay connection-fatal AND on the record.
    ("channeld_tpu_torch/core/edge.py",
     r"^(note_egress|note_drain|note_frames|edge_tick|quarantine|"
     r"_trim_to_watermark|_structured_disconnect|mark_full_resync)$"),
    ("channeld_tpu_torch/core/connection.py",
     r"^(on_bytes|receive_message|flush|flush_ingest|flush_pending)$"),
    ("channeld_tpu_torch/core/ddos.py", r"^check_unauth_conns_once$"),
    # The fuzz harness's catches ARE its oracle: each one must file a
    # Violation (traceback.format_exc on the record) or log warning+.
    ("channeld_tpu_torch/chaos/fuzz.py", r"^(_feed|_pump_sync|run_case)$"),
)

_LOG_OK = {"warning", "error", "exception", "critical"}
_ACCOUNT_CALLS = {"_count", "_note", "_event", "count_shed", "append_event",
                  "span", "event", "stage",
                  # Edge-plane double-entry ledgers (core/edge.py) and the
                  # fuzzer's violation record (the captured traceback IS
                  # the trace).
                  "count_quarantine", "count_malformed", "count_egress_drop",
                  "count_reap", "format_exc"}


def _absolved(handler: ast.ExceptHandler) -> bool:
    """True when the handler body leaves a trace (raise / metric /
    warn+ log / trace span / ledger call)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is None:
            continue
        parts = name.split(".")
        tail = parts[-1]
        if tail in _LOG_OK:
            return True
        if "metrics" in parts[:-1] and tail in ("inc", "dec", "set",
                                                "observe", "labels"):
            return True
        if tail in ("inc", "dec", "observe") and "labels" in parts:
            return True
        if tail in _ACCOUNT_CALLS:
            return True
    return False


class ExceptHygieneRule(Rule):
    name = "except-hygiene"
    description = (
        "broad excepts in tick/trunk/adoption paths must re-raise, bump "
        "a metric, log at warning+, or record a trace span"
    )

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        scoped = [fn for fn in iter_functions(mod.tree)
                  if match_scope(mod.rel, fn.name, SCOPE)]
        if not scoped:
            return []
        findings: list[Finding] = []
        for fn in scoped:
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                def _broad_name(t: ast.AST) -> bool:
                    return (isinstance(t, ast.Name)
                            and t.id in ("Exception", "BaseException"))

                broad = (
                    node.type is None
                    or _broad_name(node.type)
                    or (isinstance(node.type, ast.Tuple)
                        and any(_broad_name(e) for e in node.type.elts))
                )
                if not broad or _absolved(node):
                    continue
                findings.append(Finding(
                    rule=self.name,
                    path=mod.rel,
                    line=node.lineno,
                    message="broad except swallows the failure with no "
                            "metric, warn+ log, span, or re-raise on the "
                            "record",
                    detector="swallowed-broad-except",
                    scope=fn.qualname,
                ))
        return findings
